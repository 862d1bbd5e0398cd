"""The port's Radio session on the CPU, against the JAX package's Radio and
after tests/test_radio_app.py, test_retune.py, test_split_rit.py,
test_multirx.py and test_stage_toggles.py (the Radio parts): sim session
audio, retune without a rebuild, CAT retune over a rigctld socket, the
record taps, band memory, volume and mute, the heartbeat and
ReturnFrequency, the zoom re-capture, RIT and split, four channels with
DGT-IQ, the stage buttons and sliders.  Per-channel audio >= 80 dB
against the JAX Radio on the same hardware."""

import socket

import numpy as np
import pytest
import torch

from quisk_tpu.app.config import RadioConfig as JRadioConfig
from quisk_tpu.app.radio import Radio as JRadio
from quisk_tpu.hw.base import Hardware as JHardware

from quisk_tpu_torch.app.config import RadioConfig, Settings
from quisk_tpu_torch.app.radio import Radio
from quisk_tpu_torch.hw.base import Hardware, SimHardware
from quisk_tpu_torch.io import sources, wav

FS = 48000.0
B = 2048
AUDIO_DB = 80.0


@pytest.fixture(autouse=True)
def _one_thread():
    """Torch on one CPU thread (ROADMAP: multi-threaded cos/sin traps)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(cls=RadioConfig, **kw):
    return cls(**{**dict(sample_rate=FS, audio_block=B, mode="USB",
                         tune_hz=10000.0, agc=True), **kw})


def snr_db(ref, got) -> float:
    ref = np.asarray(ref, np.complex128)
    err = np.asarray(got, np.complex128) - ref
    return float(10 * np.log10(np.mean(np.abs(ref) ** 2)
                               / max(np.mean(np.abs(err) ** 2), 1e-30)))


def _peak_hz(seg, fs=FS):
    seg = np.asarray(seg, np.float64)
    X = np.abs(np.fft.rfft(seg * np.hanning(len(seg))))
    return np.fft.rfftfreq(len(seg), 1.0 / fs)[np.argmax(X)]


def _rms(x):
    return float(np.sqrt(np.mean(np.square(np.asarray(x, np.float64)))))


def _band_hw(base, iq):
    class BandHardware(base):
        """One wideband capture shared by all demod banks."""

        def __init__(self):
            super().__init__()
            self.pos = 0
            self.freq_calls = []

        def read_samples(self, n):
            if self.pos + n > len(iq):
                return None
            out = iq[self.pos:self.pos + n]
            self.pos += n
            return out[None]

        def ChangeFrequency(self, tx_freq, vfo_freq, source="", band=""):
            self.freq_calls.append((tx_freq, vfo_freq))
            return super().ChangeFrequency(tx_freq, vfo_freq, source, band)

    return BandHardware()


# --------------------------------------------------------- sim sessions
def test_sim_session_equals_the_jax_radio_and_retunes_without_rebuild():
    r = Radio(_cfg(), hardware="sim", device="cpu")
    j = JRadio(_cfg(JRadioConfig), hardware="sim")
    for radio in (r, j):
        radio.hw.tone_hz = 11000.0       # 1 kHz above the USB carrier
        radio.open()
    a, ja = r.run(blocks=4), j.run(blocks=4)
    assert a.shape == ja.shape == (1, 4 * B) and a.dtype == np.float32
    for k in range(4):
        assert snr_db(ja[0, k * B:(k + 1) * B],
                      a[0, k * B:(k + 1) * B]) >= AUDIO_DB, k
    assert abs(_peak_hz(a[0, -2 * B:]) - 1000.0) < 30.0
    assert r.waterfall.pixels().shape[0] >= 1
    assert abs(r.smeter_db() - j.smeter_db()) < 1e-3
    # retune: the chain is retuned as data (its decimators and carried
    # state are the same objects), and the beat follows
    stages, state = r.chain.stages, r._state
    for radio in (r, j):
        radio.hw.tone_hz = 14000.0
        radio.set_frequency(13000.0)
    assert r.chain.stages is stages and r._state is state
    assert r.cfg.tune_hz == 13000.0 and r.hw.tx_frequency == 13000
    a, ja = r.run(blocks=4), j.run(blocks=4)
    for k in range(4):
        assert snr_db(ja[0, k * B:(k + 1) * B],
                      a[0, k * B:(k + 1) * B]) >= AUDIO_DB, k
    assert abs(_peak_hz(a[0, -2 * B:]) - 1000.0) < 30.0
    r.close()
    j.close()


def test_cat_control_retunes_over_a_socket():
    radio = Radio(_cfg(), hardware="sim", rigctl_port=0, device="cpu")
    try:
        radio.hw.tone_hz = 8000.0
        radio.open()
        radio.run(blocks=2)
        with socket.create_connection(("127.0.0.1", radio.rigctl.port),
                                      timeout=5) as s:
            fobj = s.makefile("rwb")
            fobj.write(b"F 7000\n")
            fobj.flush()
            assert fobj.readline().strip() == b"RPRT 0"
            fobj.write(b"f\n")
            fobj.flush()
            assert fobj.readline().strip() == b"7000"
        assert radio.cfg.tune_hz == 7000.0   # CAT change reached the chain
        audio = radio.run(blocks=6)[0]
    finally:
        radio.close()
    assert abs(_peak_hz(audio[-3 * B:]) - 1000.0) < 30.0


def test_record_taps_write_audio_and_iq(tmp_path):
    r = Radio(RadioConfig(sample_rate=FS, tune_hz=10000.0), hardware="sim",
              device="cpu")
    r.open()
    p1 = str(tmp_path / "spk.wav")
    r.start_record(p1, kind="audio")
    a = r.run(blocks=3)
    assert r.stop_record() == p1
    got, fs = wav.read_audio_wav(p1)
    assert fs == FS and got.shape[-1] == 3 * r.chain.block_audio
    # int16 truncation (x 32767 on write, / 32768 on read): under 2 LSB
    assert np.max(np.abs(got - np.clip(a[0], -1, 1))) <= 2.0 / 32767
    p2 = str(tmp_path / "raw.wav")
    r.start_record(p2, kind="iq")
    r.run(blocks=2)
    assert r.stop_record() == p2
    iq, fs2 = wav.read_iq_wav(p2)
    assert fs2 == FS and iq.shape[-1] == 2 * r.chain.block_in
    assert abs(np.mean(np.abs(iq)) - r.hw.amplitude) < 0.01
    with pytest.raises(ValueError):
        r.start_record(p2, kind="video")
    r.close()
    assert r.stop_record() is None


def test_band_switching_with_per_band_memory(tmp_path):
    s = Settings(tmp_path / "s.json")
    r = Radio(RadioConfig(sample_rate=192000.0), hardware="sim", settings=s,
              device="cpu")
    r.set_band("40")
    assert r.cfg.mode == "LSB" and r.vfo_hz == 7_150_000
    assert r.freq_hz == 7_150_000
    r.set_frequency(7_162_000.0)
    r.set_mode("CWL")
    r.set_band("20")
    assert r.cfg.mode == "USB" and r.vfo_hz == 14_170_000
    r.set_band("40")
    assert (r.freq_hz, r.cfg.mode) == (7_162_000.0, "CWL")
    assert r.vfo_hz == 7_150_000
    s.save()
    r2 = Radio(RadioConfig(sample_rate=192000.0), hardware="sim",
               settings=Settings(tmp_path / "s.json"), device="cpu")
    r2.set_band("20")
    assert r2.vfo_hz == 14_170_000
    r2.set_band("40")
    assert (r2.freq_hz, r2.cfg.mode) == (7_162_000.0, "CWL")


def test_volume_and_mute(tmp_path):
    s = Settings(tmp_path / "s.json")
    r = Radio(RadioConfig(sample_rate=FS, tune_hz=10000.0, agc=False),
              hardware="sim", settings=s, device="cpu")
    r.open()
    r.run(blocks=4)
    full = _rms(r.run(blocks=4))
    r.set_volume(0.25)
    quarter = _rms(r.run(blocks=4))
    assert np.isclose(quarter, 0.25 * full, rtol=0.2), (full, quarter)
    r.set_mute(True)
    assert np.abs(r.run(blocks=1)).max() == 0.0
    r.set_mute(False)
    r.close()
    r2 = Radio(RadioConfig(sample_rate=FS), hardware="sim",
               settings=Settings(tmp_path / "s.json"), device="cpu")
    assert r2.volume == 0.25


def test_hardware_heartbeat_and_return_frequency():
    class KnobHW(Hardware):
        def __init__(self):
            super().__init__()
            self.beats = 0
            self.knob = None

        def read_samples(self, n):
            return np.zeros((1, n), np.complex64)

        def HeartBeat(self):
            self.beats += 1

        def ReturnFrequency(self):
            k, self.knob = self.knob, None
            return (k, None) if k is not None else (None, None)

    hw = KnobHW()
    r = Radio(RadioConfig(sample_rate=FS, tune_hz=7000.0, agc=False),
              hardware=hw, device="cpu")
    for _ in range(30):
        r.run_once()
    assert hw.beats >= 10                  # ~10 Hz at 48k/2048 blocks
    hw.knob = 9000
    r.run_once()
    assert r.freq_hz == 9000.0
    assert hw.tx_frequency == 9000


def test_zoom_recapture_resolves_two_tones_in_one_base_bin():
    class TwoTone(SimHardware):
        def read_samples(self, n):
            t = (np.arange(n) + self._n0) / self.sample_rate
            self._n0 += n
            x = (0.5 * np.exp(2j * np.pi * 40000.0 * t)
                 + 0.5 * np.exp(2j * np.pi * 40080.0 * t))
            return x.astype(np.complex64)[None]

    cfg = RadioConfig(sample_rate=192000.0, mode="USB", tune_hz=10000.0)
    hw = TwoTone(cfg)
    hw._n0 = 0
    radio = Radio(cfg, hardware=hw, device="cpu")
    radio.open()
    base_bin = cfg.sample_rate / radio.graph.sa.fft_size
    assert base_bin > 80.0
    radio.set_zoom(64.0, radio.vfo_hz + 40040.0)
    radio.run(blocks=6)
    assert radio._zoomcap is not None
    zs = radio._zoomcap[0]
    assert zs.decim <= 64.0
    zrow = radio._zoom_trace()
    radio.close()
    lo, bin_hz, row = zrow
    zres = cfg.sample_rate / (zs.decim * zs.an.fft_size)
    assert zres < base_bin / 2
    r = row - row.min()
    pk = [i for i in range(1, len(r) - 1)
          if r[i] >= r[i - 1] and r[i] >= r[i + 1] and r[i] > 0.7 * r.max()]
    groups = []
    for i in pk:
        if groups and i - groups[-1][-1] <= 2:
            groups[-1].append(i)
        else:
            groups.append([i])
    freqs = sorted(lo + bin_hz * (np.mean(g) + 0.5) for g in groups)
    assert len(freqs) == 2, freqs
    assert abs(freqs[0] - (radio.vfo_hz + 40000.0)) < 2 * zres
    assert abs(freqs[1] - (radio.vfo_hz + 40080.0)) < 2 * zres


def test_filter_response_and_runtime_flags(tmp_path):
    s = Settings(tmp_path / "s.json")
    r = Radio(RadioConfig(name="r9", sample_rate=FS, tune_hz=7000.0),
              hardware="sim", settings=s, device="cpu")
    fr = r.filter_response()
    assert 2500.0 < fr["bw6_hz"] < 3200.0
    r.set_bandwidth(1500.0)
    assert 1200.0 < r.filter_response()["bw6_hz"] < 1800.0
    r.set_flag("graph_refresh", 12)
    assert r.get_flag("graph_refresh") == 12
    assert r.flags_dict(changed_only=True)["graph_refresh"]["changed"]
    r2 = Radio(RadioConfig(name="r9", sample_rate=FS), hardware="sim",
               settings=Settings(tmp_path / "s.json"), device="cpu")
    assert r2.get_flag("graph_refresh") == 12


def test_radio_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Radio(RadioConfig(sample_rate=FS), hardware="sim")


def test_slice_7b_methods_are_not_defined():
    """The slice 7b surfaces are all there now: the port's Radio has every
    method and property of the reference's but _analytics_ctx (the
    reference's CPU pinning of its analytics, a TPU workaround)."""
    ref = {n for n in dir(JRadio) if not n.startswith("__")}
    ours = {n for n in dir(Radio) if not n.startswith("__")}
    assert ref - ours == {"_analytics_ctx"}
    for name in ("enable_cat_serial", "enable_k4", "enable_tci",
                 "tci_transmit_once", "enable_webui", "enable_audio_out",
                 "play", "enable_mic", "play_cq", "enable_serial_key",
                 "enable_midi", "enable_favorites", "save_memory",
                 "station_markers"):
        assert callable(getattr(Radio, name)), name


# --------------------------------------------------------- RIT and split
def test_rit_shifts_demod_only():
    n = 16 * B
    iq = sources.tone(8000.0, FS, n).astype(np.complex64) * 0.3
    hw = _band_hw(Hardware, iq)
    r = Radio(RadioConfig(sample_rate=FS, tune_hz=7000.0, agc=False),
              hardware=hw, device="cpu")
    assert abs(_peak_hz(r.run(4)[0][-4096:]) - 1000.0) < 15.0
    calls = len(hw.freq_calls)
    r.set_rit(200.0)
    assert r.rit_on
    assert abs(_peak_hz(r.run(4)[0][-4096:]) - 800.0) < 15.0
    assert r.freq_hz == 7000.0 and len(hw.freq_calls) == calls
    r.set_rit(200.0, on=False)
    assert abs(_peak_hz(r.run(4)[0][-4096:]) - 1000.0) < 15.0


def test_split_monitor_bank_routes_and_cat():
    n = 10 * B
    iq = (0.3 * sources.tone(8000.0, FS, n)
          + 0.3 * sources.tone(10500.0, FS, n)).astype(np.complex64)
    hw = _band_hw(Hardware, iq)
    r = Radio(RadioConfig(sample_rate=FS, tune_hz=7000.0, channels=2,
                          agc=False), hardware=hw, device="cpu")
    r.set_split(True, tx_freq=10000.0 + r.vfo_hz, play=1)
    assert r.split_rxtx == 1 and r.channel_modes[1] == "USB"
    assert r.offsets[1] == 10000.0
    assert r.routes[0] == "right" and r.routes[1] == "left"
    audio = r.run(5)
    stereo = r.mix_stereo(audio[:, -4096:])
    assert abs(_peak_hz(stereo[0]) - 500.0) < 15.0    # left = TX monitor
    assert abs(_peak_hz(stereo[1]) - 1000.0) < 15.0   # right = RX
    assert hw.freq_calls[-1][0] == int(10000.0 + r.vfo_hz)
    r.set_split(True, tx_freq=10000.0 + r.vfo_hz, play=4)
    assert r.routes[0] == "off" and r.routes[1] == "both"
    r.set_split(False)
    assert r.split_rxtx == 0 and r.tx_freq_hz == r.freq_hz
    assert r.routes[0] == "both"
    # hamlib order: S 1 VFOB, then I <freq>
    st = r._cat_state()
    st.set("split", True)
    assert r.split_rxtx and r.tx_freq_hz == r.freq_hz + 3000.0
    st.set("tx_freq", int(r.vfo_hz + 9000.0))
    assert r.tx_freq_hz == r.vfo_hz + 9000.0 and r.offsets[1] == 9000.0
    st.set("split", False)
    assert not r.split_rxtx


def test_split_tx_rotation_for_soundcard_radios():
    iq = np.zeros(20 * B, np.complex64)
    mic = (0.3 * np.sin(2 * np.pi * 1000.0 * np.arange(B) / FS)
           ).astype(np.float32)
    for dds, want_hz in ((False, 5000.0), (True, 1000.0)):
        hw = _band_hw(Hardware, iq)
        hw.tx_dds = dds
        r = Radio(RadioConfig(sample_rate=FS, tune_hz=7000.0, agc=False),
                  hardware=hw, device="cpu")
        r.enable_tx()
        r.set_split(True, tx_freq=r.vfo_hz + 4000.0)
        for _ in range(2):
            out = r.transmit(mic, ptt=True)
        X = np.abs(np.fft.fft(out * np.hanning(len(out))))
        f = np.fft.fftfreq(len(out), 1.0 / FS)
        assert abs(f[np.argmax(X)] - want_hz) < 30.0, dds


# ------------------------------------------- multi-RX, DGT-IQ, notches
def _band(n):
    """USB voice at +7 kHz, AM at -10 kHz, a tone for DGT-IQ at +15.4."""
    voice = sources.voice_like(FS, n, band=(300.0, 2400.0))
    voice *= 0.4 / np.abs(voice).max()
    iq = sources.ssb_signal(voice, FS, carrier_hz=7000.0)
    am_audio = sources.voice_like(FS, n, seed=5, band=(200.0, 3000.0))
    am_audio *= 0.5 / np.abs(am_audio).max()
    iq = iq + 0.6 * sources.am_signal(am_audio, FS, carrier_hz=-10000.0)
    iq = iq + 0.5 * sources.tone(15400.0, FS, n)
    return iq.astype(np.complex64)


def test_four_channels_with_dgt_iq_equal_the_jax_radio():
    nblk = 6
    iq = _band(nblk * B)
    radios = []
    for cls, cfg_cls, base in ((Radio, RadioConfig, Hardware),
                               (JRadio, JRadioConfig, JHardware)):
        kw = {"device": "cpu"} if cls is Radio else {}
        r = cls(cfg_cls(sample_rate=FS, channels=4, mode="USB",
                        tune_hz=7000.0, agc=False),
                hardware=_band_hw(base, iq), **kw)
        r.set_sub_rx(1, freq_hz=-10000.0, mode="AM", route="left")
        r.set_sub_rx(2, freq_hz=15000.0, mode="DGT_IQ")
        r.set_sub_rx(3, freq_hz=7000.0, mode="USB", route="right")
        r.open()
        radios.append(r)
    r, j = radios
    outs = [(r.run_once(), j.run_once(), r.digital_output(2),
             j.digital_output(2)) for _ in range(nblk)]
    for k, (a, ja, d, jd) in enumerate(outs):
        assert a.shape == (4, B) and not np.iscomplexobj(a)
        for c in (0, 1, 3):
            assert snr_db(ja[c], a[c]) >= AUDIO_DB, (k, c)
        assert np.iscomplexobj(d) and snr_db(jd, d) >= AUDIO_DB, k
    seg = outs[-1][2][256:]
    X = np.abs(np.fft.fft(seg * np.hanning(len(seg))))
    f = np.fft.fftfreq(len(seg), 1 / r.chain.fs_audio)
    assert abs(f[np.argmax(X)] - 400.0) < 50.0       # the tone at +400 Hz
    audio = np.concatenate([o[0] for o in outs], axis=-1)
    stereo = r.mix_stereo(audio)
    tail = slice(4 * B, None)
    np.testing.assert_allclose(stereo[0][tail], (audio[0] + audio[1])[tail],
                               atol=1e-6)
    np.testing.assert_allclose(stereo[1][tail], (audio[0] + audio[3])[tail],
                               atol=1e-6)
    assert np.allclose(audio[3][tail], audio[0][tail], atol=1e-5)
    g = r.multirx_graph()
    assert g is not None and g.shape[0] == 3
    jg = j.multirx_graph()
    lit = jg > jg.max() - 60.0         # bins well above float32 rounding
    assert lit.sum() > 50 and np.max(np.abs(g - jg)[lit]) <= 1e-3


def test_manual_notch_carves_the_channel_filter(tmp_path):
    s = Settings(tmp_path / "s.json")
    iq = (0.3 * sources.tone(8500.0, FS, 12 * B)).astype(np.complex64)
    r = Radio(RadioConfig(sample_rate=FS, tune_hz=7000.0, agc=False),
              hardware=_band_hw(Hardware, iq), settings=s, device="cpu")
    before = _rms(r.run(3)[0][-B:])
    r.add_notch(8500.0, 100.0)              # 1.5 kHz audio, in the passband
    notched = _rms(r.run(3)[0][-B:])
    assert notched < 0.05 * before, (before, notched)
    r.set_notch_active(8500.0, False)
    assert _rms(r.run(3)[0][-B:]) > 0.5 * before
    s.save()
    assert Settings(tmp_path / "s.json").get_state()["notches"] == [
        [8500.0, 100.0, False]]


# ------------------------------------------------ stage buttons, sliders
def test_featured_session_and_stage_buttons_equal_the_jax_radio():
    """A Radio with every optional RX stage against the JAX Radio on one
    capture (voice, a steady 1.2 kHz audio tone, noise and impulses), the
    NR stage switched off mid-run on both: >= 80 dB a block from block 3
    (the featured chain's start-up residue before it)."""
    nblk = 7
    n = nblk * B
    rng = np.random.default_rng(11)
    voice = sources.voice_like(FS, n, band=(300.0, 2400.0))
    voice *= 0.4 / np.abs(voice).max()
    tone = 0.3 * np.sin(2 * np.pi * 1200.0 * np.arange(n) / FS)
    iq = sources.ssb_signal(voice + tone, FS, carrier_hz=7000.0)
    iq = iq + 0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    iq[rng.integers(0, n, 12)] += 5.0
    iq = iq.astype(np.complex64)
    kw = dict(sample_rate=FS, tune_hz=7000.0, agc=True, noise_blanker=2,
              auto_notch=True, nr=True, anf=True)
    r = Radio(RadioConfig(**kw), hardware=_band_hw(Hardware, iq),
              device="cpu")
    j = JRadio(JRadioConfig(**kw), hardware=_band_hw(JHardware, iq))
    assert r.stage_states() == j.stage_states()
    for k in range(nblk):
        if k == 4:
            for radio in (r, j):
                radio.set_stage("nr", False)
        a, ja = r.run_once(), j.run_once()
        if k >= 3:
            assert snr_db(ja[0], a[0]) >= AUDIO_DB, k
    assert r.stage_states() == j.stage_states()


class _Zeros(Hardware):
    def read_samples(self, n):
        return np.zeros((1, n), np.complex64)


def test_stage_buttons_are_data():
    r = Radio(RadioConfig(sample_rate=FS, tune_hz=7000.0, agc=True, nr=True,
                          auto_notch=True, noise_blanker=1),
              hardware=_Zeros(), device="cpu")
    assert r.stage_states() == {"nb": True, "notch": True, "nr": True,
                                "agc": True}
    r.set_stage("nr", False)
    assert r.stage_states()["nr"] is False
    r.set_stage("agc", False, channel=0)
    assert r.stage_states()["agc"] is False
    r.set_nb_level(3)
    assert float(r.chain.nb.limit) == 2.5 and r.stage_states()["nb"]
    r.set_nb_level(0)
    assert r.stage_states()["nb"] is False
    with pytest.raises(KeyError):
        r.set_stage("anf", True)
    r.run_once()


def test_level_sliders_are_data():
    r = Radio(RadioConfig(sample_rate=FS, tune_hz=7000.0, agc=True,
                          squelch=True, squelch_threshold=1.2),
              hardware=_Zeros(), device="cpu")
    r.set_squelch_level(2.5)
    assert float(r.chain.squelch.threshold) == 2.5
    r.set_agc_level(max_gain_db=40.0, target=0.5)
    assert abs(float(r.chain.agc.max_lgain)
               - 40.0 * np.log(10.0) / 20.0) < 1e-6
    assert float(r.chain.agc.target) == 0.5
    r.run_once()
    r.enable_tx()
    r.set_fdx(True)
    assert r.tx_monitor
    r.set_sidetone(0.7)
    assert r.sidetone.level == 0.7
    r2 = Radio(RadioConfig(sample_rate=FS, tune_hz=7000.0, agc=False,
                           fm_squelch=True, mode="FM"),
               hardware=_Zeros(), device="cpu")
    r2.set_squelch_level(-50.0)
    assert float(r2.chain.fm_sq.threshold_db) == -50.0
    r3 = Radio(RadioConfig(sample_rate=FS, tune_hz=7000.0, agc=False),
               hardware=_Zeros(), device="cpu")
    with pytest.raises(KeyError):
        r3.set_squelch_level(1.0)
    with pytest.raises(KeyError):
        r3.set_agc_level(max_gain_db=10.0)


def test_set_bandwidth_narrows_filter_live():
    class HW(Hardware):
        def __init__(self):
            super().__init__()
            self.t = 0

        def read_samples(self, n):
            iq = 0.3 * np.exp(2j * np.pi * 9200.0
                              * (np.arange(n) + self.t) / FS)
            self.t += n
            return iq[None].astype(np.complex64)

    r = Radio(RadioConfig(sample_rate=FS, tune_hz=7000.0, agc=False),
              hardware=HW(), device="cpu")

    def tone_rms(blocks=4):
        return _rms(r.run(blocks)[0][-4096:])

    wide = tone_rms()                       # 2.2 kHz audio in 2.8k default
    r.set_bandwidth(1500.0)                 # passband now 300..1800
    narrow = tone_rms()
    assert wide > 0.05 and narrow < wide * 0.02, (wide, narrow)
    r.set_bandwidth(None)
    assert tone_rms() > 0.05


def test_balance_trim_needs_the_conditioner_and_persists(tmp_path):
    s = Settings(tmp_path / "s.json")
    r = Radio(RadioConfig(sample_rate=FS, tune_hz=7000.0, front_cond=True),
              hardware="sim", settings=s, device="cpu")
    r.set_ampl_phase(0.1, 2.0)
    assert r.ampl_phase == (0.1, 2.0)
    r.run_once()
    s.save()
    r2 = Radio(RadioConfig(sample_rate=FS, tune_hz=7000.0, front_cond=True),
               hardware="sim", settings=Settings(tmp_path / "s.json"),
               device="cpu")
    assert r2.ampl_phase == (0.1, 2.0)
    r3 = Radio(RadioConfig(sample_rate=FS), hardware="sim", device="cpu")
    with pytest.raises(ValueError):
        r3.set_ampl_phase(0.1, 2.0)
