"""The port's Radio transmitting, on the CPU, after tests/test_tx_runtime.py
(without its live-capture and CQ-keyer tests: those devices are slice 7b):
the half-duplex CW session, the SSB session against the JAX Radio (TX IQ
and RX audio >= 80 dB a block), the live TX -> simulated PA -> RX loopback
session (the port's own copy of examples/demo_transceiver.py
``live_session``), VOX keying, the test tone, and the PureSignal loop.  The
port's TxALC is a per-sample loop of torch ops, ~0.3 s a block at C=1 on
the CPU, so each session runs the blocks its assertion needs."""

import numpy as np
import pytest
import torch
from scipy.signal import firwin, hilbert

from quisk_tpu.app.config import RadioConfig as JRadioConfig
from quisk_tpu.app.radio import Radio as JRadio

from quisk_tpu_torch.app.config import RadioConfig
from quisk_tpu_torch.app.radio import Radio
from quisk_tpu_torch.hw.base import Hardware
from quisk_tpu_torch.io import sources
from quisk_tpu_torch.tx.puresignal import SimulatedPA, two_tone_imd_db

FS = 48000.0
B = 2048
TX_DB = 80.0


@pytest.fixture(autouse=True)
def _one_thread():
    """Torch on one CPU thread (ROADMAP: multi-threaded cos/sin traps)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class ArrayMic:
    """A microphone that hands out an array block by block, then silence
    (the role of the live capture device, which is slice 7b)."""

    def __init__(self, data):
        self.data = np.asarray(data, np.float32)
        self.pos = 0

    def get(self, n):
        out = np.zeros(n, np.float32)
        seg = self.data[self.pos:self.pos + n]
        out[:len(seg)] = seg
        self.pos += n
        return out

    def stop(self):
        pass


def _rms(x):
    return float(np.sqrt(np.mean(np.square(np.asarray(x, np.float64)))))


def snr_db(ref, got) -> float:
    ref = np.asarray(ref, np.complex128)
    err = np.asarray(got, np.complex128) - ref
    return float(10 * np.log10(np.mean(np.abs(ref) ** 2)
                               / max(np.mean(np.abs(err) ** 2), 1e-30)))


def test_half_duplex_cw_session():
    """Keyed CW inside run_once: sidetone and TX IQ while keyed, RX back
    after key-up, and no block edge clicks."""
    radio = Radio(RadioConfig(sample_rate=FS, audio_block=B, mode="CWU",
                              tune_hz=10000.0), hardware="sim", device="cpu")
    radio.open()
    radio.enable_tx(sidetone_level=0.3)
    writes = []
    radio.hw.write_samples = lambda iq: writes.append(np.asarray(iq))
    schedule = [False] * 4 + [True] * 5 + [False] * 4
    blocks = []
    for k in schedule:
        radio.set_cw_key(k)
        blocks.append(radio.run_once()[0])
    audio = np.concatenate(blocks)
    assert _rms(audio[: 3 * B]) > 0.05
    seg = audio[6 * B: 9 * B]              # fully keyed: the sidetone
    f = np.fft.rfftfreq(len(seg), 1.0 / FS)
    peak = f[np.argmax(np.abs(np.fft.rfft(seg * np.hanning(len(seg)))))]
    assert abs(peak - 600.0) < 20.0, peak
    assert 0.15 < _rms(seg) < 0.28, _rms(seg)
    assert len(writes) == 5
    assert float(np.abs(writes[2]).max()) > 0.9
    assert _rms(audio[-2 * B:]) > 0.05
    assert float(np.abs(np.diff(audio)).max()) < 0.2
    radio.close()


def test_half_duplex_ssb_session_equals_the_jax_radio():
    """PTT SSB session: RX muted while keyed, the mic tone as USB energy,
    RX back after release; TX IQ and RX audio equal the JAX Radio's."""
    tone = (0.3 * np.sin(2.0 * np.pi * 1000.0 * np.arange(16 * B) / FS)
            ).astype(np.float32)
    radios, writes = [], ([], [])
    for (cls, cfg_cls), w in zip(((Radio, RadioConfig),
                                  (JRadio, JRadioConfig)), writes):
        kw = {"device": "cpu"} if cls is Radio else {}
        r = cls(cfg_cls(sample_rate=FS, audio_block=B, mode="USB",
                        tune_hz=9000.0), hardware="sim", **kw)
        r.open()
        r.enable_tx()
        r.mic = ArrayMic(tone)
        r.hw.write_samples = w.append
        radios.append(r)
    nblk = 10
    outs = []
    for i in range(nblk):
        row = []
        for r in radios:
            r.set_ptt(3 <= i < 6)
            row.append(r.run_once()[0])
        outs.append(row)
    for k, (a, ja) in enumerate(outs):
        if _rms(ja) > 1e-3:
            assert snr_db(ja, a) >= TX_DB, k
    ours, ref = writes
    assert len(ours) == len(ref) == 3      # one TX block per keyed loop
    for k, (iq, jiq) in enumerate(zip(ours, ref)):
        assert snr_db(jiq, iq) >= TX_DB, k
    audio = np.concatenate([a for a, _ in outs])
    assert _rms(audio[: 3 * B]) > 0.05
    assert _rms(audio[4 * B: 6 * B]) < 0.01
    assert _rms(audio[-2 * B:]) > 0.05
    iq = np.concatenate(ours)
    S = np.abs(np.fft.fft(iq * np.hanning(len(iq))))
    f = np.fft.fftfreq(len(iq), 1.0 / FS)
    assert abs(f[np.argmax(S)] - 1000.0) < 50.0
    usb = float(np.sum(S[(f > 100) & (f < 3000)] ** 2))
    lsb = float(np.sum(S[(f < -100) & (f > -3000)] ** 2))
    assert usb > 100.0 * lsb
    for r in radios:
        r.close()


def live_session(blocks: int = 16):
    """Mic -> TX -> simulated PA -> RX loopback, live through the
    full-duplex run_once loop with tx_monitor (the DEBUG_MIC self-test,
    sound.c:886-888): the port's copy of examples/demo_transceiver.py
    ``live_session``, with the mic handed out block by block.  Returns
    (mic voice, demodulated audio, S-meter dB while transmitting)."""
    cfg = RadioConfig(sample_rate=48000.0, audio_block=B, mode="USB",
                      tune_hz=9000.0, agc=False)
    radio = Radio(cfg, hardware="loopback", device="cpu")
    radio.open()
    radio.enable_tx()
    radio.tx_monitor = True
    radio.run_once()
    radio.transmit(np.zeros(radio.tx.block, np.float32), ptt=True)
    voice = sources.voice_like(48000.0, blocks * B, band=(400.0, 2300.0))
    voice = (0.5 * voice / np.max(np.abs(voice))).astype(np.float32)
    radio.mic = ArrayMic(voice)
    radio.set_ptt(True)
    outs = [radio.run_once()[0] for _ in range(blocks)]
    smeter = radio.smeter_db()
    radio.set_ptt(False)
    radio.run_once()
    radio.close()
    return voice, np.concatenate(outs), smeter


def test_live_loopback_session_recovers_voice():
    voice, audio, smeter = live_session(blocks=14)
    assert smeter > -40.0, smeter
    seg = slice(6 * B, 14 * B)
    core = firwin(257, [500.0, 2200.0], fs=FS, pass_zero=False)
    v = np.convolve(voice[seg], core, "same")
    a = np.convolve(audio[seg], core, "same")
    av, aa = hilbert(v), hilbert(a)
    lags = np.arange(0, 4000)
    c = np.array([np.abs(np.vdot(av[:-4000], aa[lag:lag + len(av) - 4000]))
                  for lag in lags])
    best = int(np.argmax(c))
    a2 = aa[best:best + len(av) - 4000]
    v2 = av[:len(a2)]
    rho = float(np.abs(np.vdot(v2, a2))
                / (np.linalg.norm(v2) * np.linalg.norm(a2)))
    assert rho > 0.7, (rho, best)
    assert float(np.std(np.real(a2))) > 5.0 * max(float(np.std(audio[:B])),
                                                  1e-6)


def test_vox_keys_the_loop():
    radio = Radio(RadioConfig(sample_rate=FS, audio_block=B, mode="USB",
                              tune_hz=10000.0), hardware="sim", device="cpu")
    radio.open()
    radio.enable_tx()
    radio.set_vox(True, threshold=0.05, hold_secs=0.05)   # ~1 block hold
    radio.mic = ArrayMic(0.3 * np.sin(2.0 * np.pi * 700.0 * np.arange(3 * B)
                                      / FS))
    keyed = []
    for _ in range(6):
        radio.run_once()
        keyed.append(radio.ptt.transmitting)
    assert any(keyed[:3]), keyed
    assert not any(keyed[-2:]), keyed
    radio.close()


class _Zeros(Hardware):
    def read_samples(self, n):
        return np.zeros((1, n), np.complex64)


def test_add_tone_injects_test_carrier():
    r = Radio(RadioConfig(sample_rate=FS, tune_hz=7000.0, agc=False),
              hardware=_Zeros(), device="cpu")
    silent = np.concatenate([r.run_once()[0] for _ in range(3)])
    r.add_tone(8000.0)                  # 1 kHz above the USB carrier
    loud = np.concatenate([r.run_once()[0] for _ in range(4)])
    seg = loud[-4096:]
    X = np.abs(np.fft.rfft(seg * np.hanning(len(seg))))
    f = np.fft.rfftfreq(len(seg), 1.0 / FS)
    assert _rms(silent) < 1e-6
    assert abs(f[np.argmax(X)] - 1000.0) < 15.0
    r.add_tone(0)
    off = np.concatenate([r.run_once()[0] for _ in range(4)])
    assert _rms(off[-4096:]) < 1e-6


def test_calibrate_puresignal_lowers_imd():
    """After tests/test_puresignal.py's Radio test: the closed loop on the
    IMD two-tone through SimulatedPA lowers the IMD by >= 20 dB."""
    r = Radio(RadioConfig(sample_rate=FS, mode="IMD", tune_hz=10000.0),
              hardware="sim", device="cpu")
    r.enable_tx(predistort=True, alc=False)
    pa = SimulatedPA()

    def on_air(n_blocks=4):
        st = r.tx.init_state()
        outs = []
        aud = torch.zeros((1, r.tx.block))
        for _ in range(n_blocks):
            st, iq = r.tx.step(st, aud)
            outs.append(pa(iq[0].numpy()))
        return np.concatenate(outs)

    before = two_tone_imd_db(on_air(), FS, 700.0, 1900.0)
    r.calibrate_puresignal(pa, iterations=2, blocks=4)
    after = two_tone_imd_db(on_air(), FS, 700.0, 1900.0)
    assert before > -40.0
    assert before - after >= 20.0, (before, after)
    with pytest.raises(RuntimeError):
        Radio(RadioConfig(sample_rate=FS), hardware=_Zeros(),
              device="cpu").calibrate_puresignal(pa)
