"""The port's host edge against the JAX package, on the CPU: WAV files
and signal sources, the CLI (rx, tx, info, spectrum, config with --cpu,
after tests/test_app.py), RadioConfig -> chain configs field for field,
the flag registry, a settings database written by the JAX package and
read by the port, the graph services, CW keying and the base hardware
plugins.  Audio >= 80 dB against the JAX package, dB traces within 1e-3
dB, configs, flags, settings and copied tables exactly equal."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from quisk_tpu.app import cli as jcli
from quisk_tpu.app import flags as jflags
from quisk_tpu.app import graph as jgraph
from quisk_tpu.app.config import RadioConfig as JRadioConfig
from quisk_tpu.app.config import Settings as JSettings
from quisk_tpu.app.cw import KeyEnvelope as JKeyEnvelope
from quisk_tpu.app.cw import Sidetone as JSidetone
from quisk_tpu.app.notchdb import NotchDB as JNotchDB
from quisk_tpu.hw import base as jhw
from quisk_tpu.io import sources as jsources
from quisk_tpu.io import wav as jwav
from quisk_tpu.modes import Mode as JMode
from quisk_tpu.rx import RxChain as JRxChain

from quisk_tpu_torch.app import cli
from quisk_tpu_torch.app import flags
from quisk_tpu_torch.app import graph
from quisk_tpu_torch.app.config import (RadioConfig, Settings,
                                        default_settings_path)
from quisk_tpu_torch.app.cw import KeyEnvelope, Sidetone
from quisk_tpu_torch.app.notchdb import NotchDB
from quisk_tpu_torch.hw import base as hw
from quisk_tpu_torch.io import sources, wav
from quisk_tpu_torch.modes import Mode
from quisk_tpu_torch.rx import RxChain

FS = 48000.0
AUDIO_DB = 80.0
TRACE_DB = 1e-3


@pytest.fixture(autouse=True)
def _one_thread():
    """Torch on one CPU thread (ROADMAP: multi-threaded cos/sin traps)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def snr_db(ref, got) -> float:
    ref = np.asarray(ref, np.float64)
    err = np.asarray(got, np.float64) - ref
    return float(10 * np.log10(np.mean(ref ** 2) / max(np.mean(err ** 2),
                                                       1e-30)))


# ------------------------------------------------------------ WAV, sources
@pytest.mark.parametrize("width", [2, 4])
def test_iq_wav_bytes_equal_the_reference(tmp_path, width):
    iq = (0.5 * sources.tone(1000.0, FS, 4096)
          + 0.25 * sources.tone(-8000.0, FS, 4096))
    p, q = tmp_path / "port.wav", tmp_path / "ref.wav"
    wav.write_iq_wav(str(p), iq, FS, width=width)
    jwav.write_iq_wav(str(q), iq, FS, width=width)
    assert p.read_bytes() == q.read_bytes()
    a, fs = wav.read_iq_wav(str(p))
    b, jfs = jwav.read_iq_wav(str(q))
    assert fs == jfs == FS and np.array_equal(a, b)
    assert snr_db(iq.real, a.real) > 80.0


def test_audio_wav_bytes_equal_the_reference(tmp_path):
    a = 0.7 * np.sin(2 * np.pi * 440.0 * np.arange(3000) / FS)
    p, q = tmp_path / "port.wav", tmp_path / "ref.wav"
    wav.write_audio_wav(str(p), a, FS)
    jwav.write_audio_wav(str(q), a, FS)
    assert p.read_bytes() == q.read_bytes()
    x, fs = wav.read_audio_wav(str(p))
    y, _ = jwav.read_audio_wav(str(q))
    assert fs == FS and np.array_equal(x, y)


@pytest.mark.parametrize("mode", list(Mode), ids=lambda m: m.name)
def test_station_iq_equals_the_reference(mode):
    a = sources.station_iq(mode, FS, 4096, carrier_hz=3000.0, seed=4,
                           cw_pitch=600.0)
    b = jsources.station_iq(JMode(int(mode)), FS, 4096, carrier_hz=3000.0,
                            seed=4, cw_pitch=600.0)
    assert a.dtype == b.dtype and np.array_equal(a, b)


def test_generators_equal_the_reference():
    v = sources.voice_like(FS, 5000, seed=2)
    assert np.array_equal(v, jsources.voice_like(FS, 5000, seed=2))
    assert np.array_equal(sources.awgn(v, 20.0), jsources.awgn(v, 20.0))
    assert np.array_equal(sources.two_tone(700.0, 1900.0, FS, 999),
                          jsources.two_tone(700.0, 1900.0, FS, 999))
    assert np.array_equal(sources.fm_signal(v, FS), jsources.fm_signal(v, FS))


# ----------------------------------------------------- config, flags, db
RADIOS = [
    dict(),
    dict(name="wide", sample_rate=960000.0, channels=8, mode="AM",
         agc=False, noise_blanker=2, auto_notch=True, nr=True, anf=True,
         squelch=True, squelch_threshold=1.5, fm_squelch=True,
         fm_squelch_db=-50.0, fm_deviation_hz=5000.0, cw_pitch=700.0,
         filter_taps=513, audio_block=1024, tx_rate=192000.0,
         dc_remove_bw=300, invert_spectrum=True),
    dict(front_cond=True, dc_remove_bw=1),
]


@pytest.mark.parametrize("kw", RADIOS, ids=["default", "wide", "cond"])
def test_radio_config_builds_equal_chain_configs(kw):
    cfg, jcfg = RadioConfig(**kw), JRadioConfig(**kw)
    assert cfg.to_json() == jcfg.to_json()
    assert int(cfg.modes()) == int(jcfg.modes())
    rx, jrx = cfg.rx_chain_config(), jcfg.rx_chain_config()
    jd = dataclasses.asdict(jrx)
    # the port's fields the JAX chain lacks, at defaults that change nothing
    port_only = {"ctcss_hz": 0.0}
    for f in dataclasses.fields(rx):
        want = port_only[f.name] if f.name in port_only else jd[f.name]
        assert getattr(rx, f.name) == want, f.name
    assert set(jd) - {f.name for f in dataclasses.fields(rx)} == {
        "mxu_stft"}                       # TPU-only, not ported
    tx, jtx = cfg.tx_chain_config(), jcfg.tx_chain_config()
    assert dataclasses.asdict(tx) == dataclasses.asdict(jtx)


def test_radio_config_from_flags_equals_the_reference():
    fl = flags.Flags(sample_rate=192000, graph_window="blackman",
                     agc_release_time=0.5, invertSpectrum=True)
    jfl = jflags.Flags(sample_rate=192000, graph_window="blackman",
                       agc_release_time=0.5, invertSpectrum=True)
    assert (RadioConfig.from_flags(fl, "r").to_json()
            == JRadioConfig.from_flags(jfl, "r").to_json())


def test_flag_registry_equals_the_reference():
    assert list(flags.REGISTRY) == list(jflags.REGISTRY)
    for name, fl in flags.REGISTRY.items():
        jf = jflags.REGISTRY[name]
        assert (fl.name, fl.type, fl.default, fl.help, fl.choices,
                fl.section) == (jf.name, jf.type, jf.default, jf.help,
                                jf.choices, jf.section), name
    assert flags.sections() == jflags.sections()
    assert flags.docs_markdown() == jflags.docs_markdown()


def test_settings_written_by_the_reference_load_in_the_port(tmp_path):
    path = tmp_path / "quisk_settings.json"
    js = JSettings(path)
    js.add_radio(JRadioConfig(name="hermes", sample_rate=192000.0,
                              channels=4, mode="LSB", nr=True))
    jfl = jflags.Flags()
    jfl.set("graph_refresh", 12)
    jfl.set("graph_window", "hamming")
    js.set_flags("hermes", jfl)
    js.update_state(interval_secs=0.0, band="40", tune_hz=7100000.0,
                    mode="LSB", volume=0.5, notches=[[7101000.0, 80.0, True]])
    s = Settings(path)
    assert s.radio_names() == ["hermes"]
    assert s.get_radio("hermes").to_json() == js.get_radio("hermes").to_json()
    assert s.get_flags("hermes").to_json() == jfl.to_json()
    assert s.get_state() == js.get_state()
    assert NotchDB.from_list(s.get_state()["notches"]).to_list() == \
        JNotchDB.from_list(js.get_state()["notches"]).to_list()
    # and both write the same file back, byte for byte
    s2, js2 = tmp_path / "a.json", tmp_path / "b.json"
    s.path, js.path = s2, js2
    s.save()
    js.save()
    assert s2.read_bytes() == js2.read_bytes()


def test_default_settings_path_follows_the_reference(monkeypatch, tmp_path):
    from quisk_tpu.app.config import default_settings_path as jpath
    monkeypatch.setenv("QUISK_TPU_SETTINGS", str(tmp_path / "x.json"))
    assert default_settings_path() == jpath() == tmp_path / "x.json"
    monkeypatch.delenv("QUISK_TPU_SETTINGS")
    assert default_settings_path() == jpath()
    assert default_settings_path().name == "quisk_settings.json"


# ---------------------------------------------------------------- the CLI
def _station_wav(path, seconds=1.0, fs=FS):
    n = int(seconds * fs)
    iq = 0.5 * sources.station_iq(Mode.USB, fs, n, carrier_hz=5000.0,
                                  seed=7)
    wav.write_iq_wav(str(path), iq, fs)


def test_cli_rx_equals_the_jax_cli(tmp_path):
    iq_p = tmp_path / "iq.wav"
    _station_wav(iq_p)
    out, jout = tmp_path / "a.wav", tmp_path / "b.wav"
    args = ["--in", str(iq_p), "--mode", "USB", "--tune", "5000", "--cpu"]
    assert cli.main(["rx", *args, "--out", str(out)]) == 0
    assert jcli.main(["rx", *args, "--out", str(jout)]) == 0
    a, fs = wav.read_audio_wav(str(out))
    b, jfs = jwav.read_audio_wav(str(jout))
    assert fs == jfs == FS and a.shape == b.shape
    assert snr_db(b, a) >= AUDIO_DB
    assert np.max(np.abs(a - b)) <= 2.0 / 32768.0


def test_cli_tx_equals_the_jax_cli(tmp_path):
    v = sources.voice_like(FS, 2 * 2048, seed=3)
    voice_p = tmp_path / "voice.wav"
    wav.write_audio_wav(str(voice_p), 0.5 * v / np.max(np.abs(v)), FS)
    out, jout = tmp_path / "a.wav", tmp_path / "b.wav"
    args = ["--in", str(voice_p), "--mode", "USB", "--interp", "4",
            "--compress", "6", "--cpu"]
    assert cli.main(["tx", *args, "--out", str(out)]) == 0
    assert jcli.main(["tx", *args, "--out", str(jout)]) == 0
    a, fs = wav.read_iq_wav(str(out))
    b, jfs = jwav.read_iq_wav(str(jout))
    assert fs == jfs == 4 * FS and a.shape == b.shape == (4 * 2 * 2048,)
    assert snr_db(b.real, a.real) >= AUDIO_DB
    assert snr_db(b.imag, a.imag) >= AUDIO_DB


def test_cli_info_equals_the_jax_cli(tmp_path, capsys):
    p = tmp_path / "iq.wav"
    wav.write_iq_wav(str(p), sources.tone(100.0, 960000.0, 8192), 960000.0)
    assert cli.main(["info", "--in", str(p)]) == 0
    ours = json.loads(capsys.readouterr().out)
    assert jcli.main(["info", "--in", str(p)]) == 0
    assert ours == json.loads(capsys.readouterr().out)
    assert ours["decimation_stages"] == [2, 2, 5]


def test_cli_spectrum_equals_the_jax_cli(tmp_path, capsys):
    p = tmp_path / "iq.wav"
    wav.write_iq_wav(str(p), sources.tone(6000.0, FS, 32768, amplitude=0.9),
                     FS)
    assert cli.main(["spectrum", "--in", str(p), "--cpu"]) == 0
    ours = capsys.readouterr().out
    assert jcli.main(["spectrum", "--in", str(p), "--cpu"]) == 0
    ref = capsys.readouterr().out
    assert ours == ref
    peak_hz = float(ours.split("at ")[1].split(" Hz")[0])
    assert abs(peak_hz - 6000.0) < 300.0


def test_cli_config_shares_the_settings_db_with_the_jax_cli(tmp_path,
                                                            capsys):
    db = str(tmp_path / "s.json")
    base = ["--radio", "r1", "--settings", db]
    assert cli.main(["config", "set", "graph_refresh", "11", *base]) == 0
    assert jcli.main(["config", "set", "graph_window", "hamming", *base]) == 0
    capsys.readouterr()
    for name in ("graph_refresh", "graph_window"):
        assert cli.main(["config", "get", name, *base]) == 0
        ours = capsys.readouterr().out
        assert jcli.main(["config", "get", name, *base]) == 0
        assert ours == capsys.readouterr().out
    for action in (["list", "--changed"], ["sections"], ["docs"]):
        assert cli.main(["config", *action, *base]) == 0
        ours = capsys.readouterr().out
        assert jcli.main(["config", *action, *base]) == 0
        assert ours == capsys.readouterr().out
    assert cli.main(["config", "unset", "graph_refresh", *base]) == 0
    assert cli.main(["config", "get", "nope", *base]) == 1
    assert cli.main(["config", "set", "graph_refresh", "x", *base]) == 1
    capsys.readouterr()
    assert jcli.main(["config", "list", "--changed", *base]) == 0
    assert "graph_refresh" not in capsys.readouterr().out


def test_cli_without_a_card_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p = tmp_path / "iq.wav"
    _station_wav(p, seconds=0.1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["rx", "--in", str(p)])


# ------------------------------------------------------- graph services
def test_graph_service_traces_equal_the_reference():
    rng = np.random.default_rng(5)
    B, C = 8192, 3
    kw = dict(fft_size=1024, block=B, channels=C, sample_rate=FS,
              pixels=256, refresh_hz=FS / B / 2, overlap=0.5)
    gs = graph.GraphService(device="cpu", **kw)
    jgs = jgraph.GraphService(**kw)
    for k in range(5):
        x = (0.3 * sources.tone(3000.0 + 700 * k, FS, B)[None]
             + 0.01 * (rng.standard_normal((C, B))
                       + 1j * rng.standard_normal((C, B)))
             ).astype(np.complex64)
        t, jt = gs.feed(x), jgs.feed(x)
        assert (t is None) == (jt is None)
        if t is not None:
            assert np.max(np.abs(t - jt)) <= TRACE_DB
        s, js = gs.smeter_dbfs(-3000.0, 6000.0), jgs.smeter_dbfs(-3000.0,
                                                                 6000.0)
        assert np.max(np.abs(s - js)) <= TRACE_DB
    assert len(gs.waterfall) == len(jgs.waterfall) == 2
    gs.set_window("flat-top")
    jgs.set_window("flat-top")
    assert np.array_equal(gs.freqs(), jgs.freqs())


def test_audio_fft_service_equals_the_reference():
    rng = np.random.default_rng(6)
    a = (0.4 * np.sin(2 * np.pi * 1500.0 * np.arange(2 * 2048) / FS)
         + 0.01 * rng.standard_normal(2 * 2048))
    blocks = a.reshape(2, 1, 2048).astype(np.float32)
    svc = graph.AudioFFTService(512, 2048, FS, refresh_hz=FS / 4096,
                                device="cpu")
    jsvc = jgraph.AudioFFTService(512, 2048, FS, refresh_hz=FS / 4096)
    outs = [(svc.feed(b), jsvc.feed(b)) for b in blocks]
    assert outs[0] == (None, None)
    t, jt = outs[1]
    assert t.shape == jt.shape == (1, 256)
    assert np.max(np.abs(t - jt)) <= TRACE_DB


def test_filter_response_equals_the_reference():
    from quisk_tpu.rx import RxChainConfig as JCfg
    from quisk_tpu_torch.rx import RxChainConfig
    modes = [int(Mode.USB), int(Mode.AM)]
    chain = RxChain.create(RxChainConfig(sample_rate=FS, channels=2),
                           tune_hz=0.0, mode=modes, device="cpu")
    jchain = JRxChain.create(JCfg(sample_rate=FS, channels=2), tune_hz=0.0,
                             mode=modes)
    for c in range(2):
        r = graph.filter_response(chain.bp, FS, c, 512)
        j = jgraph.filter_response(jchain.bp, FS, c, 512)
        assert np.array_equal(r["freqs_hz"], j["freqs_hz"])
        inband = j["db"] > -60.0
        assert np.max(np.abs(r["db"][inband] - j["db"][inband])) <= TRACE_DB
        assert abs(r["bw3_hz"] - j["bw3_hz"]) < 1.0
        assert abs(r["bw6_hz"] - j["bw6_hz"]) < 1.0


def test_host_display_services_equal_the_reference():
    rng = np.random.default_rng(8)
    rows = rng.uniform(-150.0, -50.0, (3, 64))
    wf, jwf = graph.WaterfallRenderer(64, rows=2), jgraph.WaterfallRenderer(
        64, rows=2)
    for r in rows:
        wf.add_row(r)
        jwf.add_row(r)
    assert np.array_equal(wf.pixels(), jwf.pixels())
    st, jst = graph.ScanStitcher(3, 40), jgraph.ScanStitcher(3, 40)
    for i in range(3):
        st.add_block(i, rows[i])
        jst.add_block(i, rows[i])
    assert st.complete() and np.array_equal(st.spectrum(), jst.spectrum())
    adc = rng.standard_normal(5000)
    bs, jbs = graph.BandscopeService(512, 1e6, 32), jgraph.BandscopeService(
        512, 1e6, 32)
    bs.add_samples(adc)
    jbs.add_samples(adc)
    assert np.array_equal(bs.spectrum_db(zoom=2.0), jbs.spectrum_db(zoom=2.0))
    x = (rng.standard_normal((2, 4096))
         + 1j * rng.standard_normal((2, 4096))).astype(np.complex64)
    sc, jsc = graph.ScopeService(256).capture(x, 1, 2), \
        jgraph.ScopeService(256).capture(x, 1, 2)
    assert all(np.array_equal(sc[k], jsc[k]) for k in ("i", "q"))
    assert np.array_equal(graph.measure_audio_rms(rows),
                          jgraph.measure_audio_rms(rows))

    class HW:
        def __init__(self):
            self.calls = []

        def ChangeFrequency(self, tx, vfo, source=""):
            self.calls.append((tx, vfo))

    h, jh = HW(), HW()
    sc = graph.ScanController(h, graph.ScanStitcher(3, 40), 1e6, 2e6, 4e5)
    jsc = jgraph.ScanController(jh, jgraph.ScanStitcher(3, 40), 1e6, 2e6,
                                4e5)
    outs = [(sc.feed(r), jsc.feed(r)) for r in rows]
    assert h.calls == jh.calls
    assert np.array_equal(outs[-1][0], outs[-1][1])
    assert np.array_equal(sc.freqs(), jsc.freqs())


# --------------------------------------------------------------- CW keying
def test_key_envelope_and_sidetone_equal_the_reference():
    key = np.repeat([0, 1, 1, 0, 1, 0, 0], 300).astype(np.float32)
    env, jenv = KeyEnvelope(FS), JKeyEnvelope(FS)
    st, jst = Sidetone(FS, 700.0, 0.4), JSidetone(FS, 700.0, 0.4)
    for blk in key.reshape(3, -1):
        assert np.array_equal(env.process(blk), jenv.process(blk))
        assert np.array_equal(st.process(blk), jst.process(blk))


# -------------------------------------------------------- hardware plugins
def test_registry_holds_the_base_plugins_and_names_the_later_slice():
    for name in ("fixed", "file", "loopback", "sim"):
        assert hw.get_hardware(name).__name__ == \
            jhw.get_hardware(name).__name__
    # the network / USB plugins (slice 7b-1) are registered too now: each
    # resolves to the port's class of the reference's name
    for name in ("afedri", "fifisdr", "hamlib", "hermes", "hiqsdr",
                 "hl2_oob", "multus", "perseus", "sdr8600", "sdriq",
                 "sdrmicron", "soapy", "softrock", "wideband"):
        assert hw.get_hardware(name).__name__ == \
            jhw.get_hardware(name).__name__, name
    with pytest.raises(KeyError, match="unknown hardware"):
        hw.get_hardware("nope")


def test_sim_and_file_hardware_equal_the_reference(tmp_path):
    cfg = RadioConfig(sample_rate=96000.0)
    sim, jsim = hw.SimHardware(cfg, n_rx=2), jhw.SimHardware(cfg, n_rx=2)
    assert sim.open() == jsim.open()
    for n in (1000, 3001):
        assert np.array_equal(sim.read_samples(n), jsim.read_samples(n))
    p = tmp_path / "iq.wav"
    _station_wav(p, seconds=0.05)
    f, jf = hw.FileHardware(path=str(p)), jhw.FileHardware(path=str(p))
    assert f.open() == jf.open()
    for n in (1000, 2000):               # wraps past the end (loop)
        assert np.array_equal(f.read_samples(n), jf.read_samples(n))
    once = hw.FileHardware(path=str(p), loop=False)
    once.open()
    assert once.read_samples(5000).shape == (1, 2400)
    assert once.read_samples(10) is None


def test_loopback_hardware_equals_the_reference():
    cfg = RadioConfig(sample_rate=FS, tune_hz=9000.0)
    lb, jlb = hw.LoopbackHardware(cfg), jhw.LoopbackHardware(cfg)
    assert lb.open() == jlb.open()
    iq = (0.8 * sources.tone(1000.0, FS, 3000)).astype(np.complex64)
    lb.write_samples(iq)
    jlb.write_samples(iq)
    for n in (2048, 2048):
        assert np.array_equal(lb.read_samples(n), jlb.read_samples(n))
    h, jh = hw.Hardware(), jhw.Hardware()
    assert h.ChangeFrequency(7, 5) == jh.ChangeFrequency(7, 5)
    h.RepeaterOffset(0.6)
    jh.RepeaterOffset(0.6)
    assert (h.tx_frequency, h.vfo_frequency) == (jh.tx_frequency,
                                                 jh.vfo_frequency) == (607, 5)
