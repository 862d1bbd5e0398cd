"""The port's network / USB hardware plugins (quisk_tpu_torch/hw/*) and its
VNA (quisk_tpu_torch/app/vna.py) against the JAX package's: each scenario
runs the same call sequence on both packages' plugins with recording fakes
for the transports, and the wire bytes, driver calls and return values
must be equal (after tests/test_hw_net_plugins.py, test_hw_plugins.py,
test_hermes_recovery.py, test_softrock_sdriq.py and test_hw_vna.py, whose
checks each scenario also makes on the port).  Then the live sample plane:
Hermes' ready handshake and status routing through the port's pumps, the
wideband plugin, and ``Radio(hardware="hiqsdr", device="cpu")`` fed over a
loopback socket, per block >= 80 dB against the JAX Radio fed the same
packets."""

import importlib
import socket
import struct
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from quisk_tpu.app.config import RadioConfig as JRadioConfig
from quisk_tpu.app.radio import Radio as JRadio
from quisk_tpu.io import sources as jsources

from quisk_tpu_torch.app.config import RadioConfig
from quisk_tpu_torch.app.radio import Radio
from quisk_tpu_torch.hw import get_hardware
from quisk_tpu_torch.io import native, pump, sources

PLUGINS = ("afedri", "fifisdr", "hamlib_hw", "hermes", "hiqsdr", "hl2_oob",
           "multus", "perseus", "sdr8600", "sdriq", "sdrmicron", "soapy",
           "softrock", "wideband")
AUDIO_DB = 80.0


def _package(name):
    ns = SimpleNamespace(**{p: importlib.import_module(f"{name}.hw.{p}")
                            for p in PLUGINS})
    ns.hw = importlib.import_module(f"{name}.hw")
    ns.vna = importlib.import_module(f"{name}.app.vna")
    return ns


PORT, REF = _package("quisk_tpu_torch"), _package("quisk_tpu")


def _equal(a, b) -> bool:
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(np.asarray(a), np.asarray(b))
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_equal(x, y) for x, y in zip(a, b)))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    return a == b


def same(scenario):
    """Run ``scenario(package)`` on the port and the reference; their
    traces must be equal.  Returns the port's trace."""
    got, want = scenario(PORT), scenario(REF)
    assert _equal(got, want), (got, want)
    return got


class Sink:
    def __init__(self):
        self.msgs = []

    def write(self, b):
        self.msgs.append(bytes(b))


class Recorder:
    """A driver / device / USB control endpoint that records each call."""

    def __init__(self, replies=None):
        self.calls = []
        self.replies = replies or {}

    def __getattr__(self, name):
        def rec(*a):
            self.calls.append((name,) + tuple(
                bytes(x) if isinstance(x, (bytes, bytearray)) else x
                for x in a))
            r = self.replies.get(name)
            return r(*a) if callable(r) else r
        return rec


class LoopTransport:
    """Records sends; echoes the last control packet (or ``reply``)."""

    def __init__(self, reply=None, flowing_after=None):
        self.sent = []
        self.reply = reply
        self.flowing_after = flowing_after

    def sendto(self, pkt):
        self.sent.append(bytes(pkt))

    def poll_ctl(self):
        if self.reply is not None:
            return self.reply
        return self.sent[-1] if self.sent else None

    def frames_flowing(self):
        starts = sum(1 for p in self.sent if len(p) == 64 and p[3] == 1)
        return self.flowing_after is not None and starts > self.flowing_after


def _iq(n, seed, scale=0.5):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-scale, scale, n)
            + 1j * rng.uniform(-scale, scale, n)).astype(np.complex64)


def _wait(cond, timeout=10.0):
    t0 = time.time()
    while not cond() and time.time() - t0 < timeout:
        time.sleep(0.002)
    assert cond(), "timed out"


def test_registry_holds_every_reference_plugin():
    for name in ("afedri", "fifisdr", "hamlib", "hermes", "hiqsdr",
                 "hl2_oob", "multus", "perseus", "sdr8600", "sdriq",
                 "sdrmicron", "soapy", "softrock", "wideband"):
        cls = get_hardware(name)
        assert cls.__module__.startswith("quisk_tpu_torch.hw.")
        assert cls.__name__ == REF.hw.get_hardware(name).__name__


# ---------------------------------------------------------------- afedri
def test_afedri_control_wire_format():
    def run(m):
        af = m.afedri
        clock = 80_000_000
        lo = (b"\x09\xe0\x02\x55" + (clock & 0xFFFF).to_bytes(2, "little")
              + b"\x00\x00\x00")
        hi = (b"\x09\xe0\x02\x55" + (clock >> 16).to_bytes(2, "little")
              + b"\x00\x00\x00")
        reply = bytearray(56)
        reply[5:11] = b"AFEDRI"
        reply[21:25] = b"SN42"
        reply[37:41] = bytes([10, 0, 0, 7])[::-1]
        reply[53:55] = (50000).to_bytes(2, "little")
        return [[af.set_center_freq(f, ch) for f in (0, 1_800_000,
                                                    14_100_000, 54_000_000)
                 for ch in (0, 1)],
                [af.set_sample_rate(r) for r in (48_000, 192_000, 1_333_333)],
                [af.set_gain(g) for g in range(-10, 36, 3)],
                [af.decode_gain(af.encode_gain(g)) for g in range(-10, 36)],
                af.set_state(True), af.set_state(False), af.request_name(),
                af.request_fe_clock_word(0), af.request_fe_clock_word(1),
                af.parse_fe_clock(lo, hi),
                [af.valid_sample_rate(r, clock)
                 for r in (1_000, 48_000, 192_000, 2_000_000)],
                af.build_discovery(), af.parse_discovery_reply(bytes(reply))]
    t = same(run)
    assert t[4] == b"\x08\x00\x18\x00\x80\x02\x00\x00"
    assert t[12] == ("AFEDRI", "SN42", "10.0.0.7", 50000)


def test_afedri_udp_packets_and_sequence():
    def run(m):
        af = m.afedri
        hw = m.hw.get_hardware("afedri")(transport=Sink())
        blocks = [_iq(256, seed) for seed in range(3)]
        pkts = [af.build_udp_packet(seq, b) for seq, b in enumerate(blocks)]
        for p in pkts:
            hw.feed_udp(p)
        got = hw.read_samples(768)
        hw.feed_udp(af.build_udp_packet(9, blocks[0]))
        hw.feed_udp(af.build_udp_packet(10, blocks[0]))
        return pkts, af.parse_udp_packet(pkts[1]), got, hw.seq_errors, \
            hw.read_samples(1000)
    pkts, _, got, errs, rest = same(run)
    assert len(pkts[0]) == PORT.afedri.RX_UDP_SIZE and errs == 1
    assert rest is None and got.shape == (1, 768)


def test_afedri_hardware_control_flow():
    def run(m):
        t = Sink()
        hw = m.hw.get_hardware("afedri")(transport=t, gain_db=-10)
        out = [hw.open()]
        hw.StartSamples()
        out.append(hw.ChangeFrequency(0, 7_100_000))
        hw.StopSamples()
        out += [hw.VarDecimGetChoices(), hw.VarDecimGetIndex(),
                [hw.VarDecimSet(i) for i in range(8)]]
        return out, t.msgs
    out, msgs = same(run)
    assert PORT.afedri.set_state(True) in msgs
    assert abs(out[-1][3] - 185_185) < 500


def test_afedri_radio_end_to_end():
    """UDP packets -> the port's afedri plugin -> its Radio on the CPU."""
    from quisk_tpu_torch.modes import Mode
    hw = get_hardware("afedri")(transport=Sink())
    r = Radio(RadioConfig(sample_rate=48000.0, tune_hz=10000.0),
              hardware=hw, device="cpu")
    r.open()
    n = 48000
    iq = np.asarray(sources.station_iq(Mode.USB, 48000.0, n,
                                       carrier_hz=10000.0, seed=3) * 0.4,
                    np.complex64)
    for k in range(0, n - 256, 256):
        hw.feed_udp(PORT.afedri.build_udp_packet(k // 256, iq[k:k + 256]))
    audio = np.asarray(r.run(blocks=8), np.float64)
    r.close()
    assert 0.01 < float(np.sqrt(np.mean(audio ** 2))) < 2.0
    assert hw.seq_errors == 0


# ---------------------------------------------------------------- perseus
def test_perseus_control_flow_and_samples():
    def run(m):
        drv = Recorder({"open_device": "perseus ok"})
        hw = m.hw.get_hardware("perseus")(driver=drv)
        out = [hw.open(), [hw.set_attenuator_index(i) for i in range(4)]]
        hw.set_wideband(True)
        hw.set_wideband(False)
        out += [hw.ChangeFrequency(0, 3_560_000), hw.ReturnVfoFloat(),
                hw.VarDecimGetChoices(), hw.VarDecimSet(7),
                hw.VarDecimGetIndex()]
        hw.feed_samples(np.arange(8, dtype=np.float32))
        out += [hw.read_samples(4), hw.read_samples(1)]
        hw.close()
        out.append(m.perseus.PerseusHardware(driver=None).open())
        return out, drv.calls
    out, calls = same(run)
    assert ("set_sampling_rate", 1000000) in calls
    assert out[-1] == "Perseus module not available"


# ---------------------------------------------------------------- soapy
class SoapyConf:
    soapy_settings = {
        "soapy_setAntenna_rx": "LNAW",
        "soapy_setSampleRate_rx": "768",
        "soapy_setBandwidth_rx": "800",
        "soapy_gain_mode_rx": "detailed",
        "soapy_gain_values_rx": {"total": "30", "LNA": "24", "PGA": "-3"},
        "soapy_setAntenna_tx": "BAND1",
        "soapy_setSampleRate_tx": "96",
        "soapy_gain_mode_tx": "total",
        "soapy_gain_values_tx": {"total": "10"},
    }


class SoapyDevice(Recorder):
    """A SoapySDR device that serves short reads, as StreamResult-alikes."""

    def __init__(self, chunk=7):
        super().__init__({"setupStream": "stream"})
        self.served = 0
        self.chunk = chunk
        self.limit = None

    def readStream(self, s, buf, n):
        if self.limit is not None and self.served >= self.limit:
            return SimpleNamespace(ret=0)
        k = min(self.chunk, n)
        buf[:k] = (np.arange(k) + self.served).astype(np.complex64)
        self.served += k
        return SimpleNamespace(ret=k)


@pytest.mark.parametrize("enable_tx", [False, True])
def test_soapy_parameter_surface(enable_tx):
    def run(m):
        d = SoapyDevice()
        hw = m.hw.get_hardware("soapy")(conf=SoapyConf(), device=d,
                                        enable_tx=enable_tx)
        return hw.open(), hw.rx_rate, d.calls
    _, rate, calls = same(run)
    assert rate == 768_000.0 and ("setGainElement", 0, 0, "LNA", 24.0) \
        in calls
    assert any(c[1] == 1 for c in calls) == enable_tx


@pytest.mark.parametrize("mode", ["automatic", "total", "detailed"])
def test_soapy_gain_modes(mode):
    def run(m):
        d = SoapyDevice()
        hw = m.soapy.SoapyHardware(device=d)
        hw._apply_gain({"soapy_gain_mode_rx": mode,
                        "soapy_gain_values_rx": {"total": 12.0, "LNA": 3}},
                       "_rx", 0)
        return d.calls
    assert same(run)


def test_soapy_frequency_stream_and_short_reads():
    def run(m):
        d = SoapyDevice()
        hw = m.soapy.SoapyHardware(device=d, enable_tx=True,
                                   transverter_offset=120e6)
        out = [hw.ChangeFrequency(145_100_000, 145_000_000),
               hw.ChangeFrequency(145_100_000, 145_000_000),
               hw.ReturnVfoFloat(), hw.VarDecimGetChoices()]
        hw.StartSamples()
        out.append(hw.read_samples(16))
        d.limit = d.served
        out.append(hw.read_samples(16))
        d.limit = None
        out.append(hw.read_samples(16))
        hw.close()
        out.append(m.soapy.SoapyHardware(device=None).open())
        return out, d.calls
    out, calls = same(run)
    np.testing.assert_array_equal(out[4][0], np.arange(16))
    assert out[5] is None
    np.testing.assert_array_equal(out[6][0], np.arange(16, 32))
    assert ("setFrequency", 0, 0, 25_000_000.0) in calls


# ------------------------------------------------------------- sdrmicron
def test_micron_control_frames():
    def run(m):
        sm = m.sdrmicron
        out = [sm.build_rx_control(en, ri, f, att)
               for en in (True, False) for ri in (0, 3, 9)
               for f in (7_220_000, 28_000_000) for att in (0, 10)]
        out += [sm.build_bscope_control(True, p) for p in (50, 100, 255)]
        try:
            sm.build_bscope_control(True, 10)
        except ValueError as e:
            out.append(str(e))
        return out
    out = same(run)
    assert out[0][:8] == b"\x55" * 7 + b"\xd5" and len(out[0]) == 32


@pytest.mark.parametrize("wide", [False, True], ids=["iq24", "iq16"])
def test_micron_frames_and_resync(wide):
    def run(m):
        sm = m.sdrmicron
        iq = _iq(123 if wide else 82, seed=6, scale=0.9)
        frame = sm.pack_rx_frame(iq, wide=wide)
        fr = sm.MicronFramer(wide=wide)
        fr.feed(b"\x01\x02junk" + frame[:100])
        fr.feed(frame[100:] + frame)
        return frame, fr.take_samples(), fr.resync_count, fr.fw_version
    frame, got, resyncs, fw = same(run)
    assert len(got) == 2 * (123 if wide else 82) and resyncs == 1


def test_micron_bandscope_assembly():
    def run(m):
        sm = m.sdrmicron
        adc = np.round(np.sin(np.arange(16384) * 0.01) * 20000).astype(">i2")
        raw = adc.tobytes()
        fr = sm.MicronFramer()
        pre = sm.PREAMBLE + b"BS0" + bytes((ord("1"), ord("0"), 0))
        for pn in range(67):
            chunk = (raw[pn * 492:(pn + 1) * 492] if pn < 66
                     else raw[66 * 492:].ljust(492, b"\0"))
            fr.feed(pre + bytes((pn, 0)) + chunk)
        return fr.take_bscope()
    out = same(run)
    assert out is not None and len(out) == 16384


def test_micron_hardware_control_flow_and_exact_blocks():
    def run(m):
        sink = Sink()
        hw = m.hw.get_hardware("sdrmicron")(transport=sink)
        out = [hw.open()]
        hw.StartSamples()
        out.append(hw.ChangeFrequency(14_200_000, 14_200_000))
        out += [hw.VarDecimGetChoices(), hw.VarDecimSet(8),
                hw.framer.wide, hw.VarDecimSet(2), hw.VarDecimGetIndex()]
        for band in ("40", "20", "160"):
            hw.ChangeBand(band)
            out.append(hw.att)
        hw.set_attenuation(20)
        iq = _iq(82, seed=7, scale=0.9)
        hw.feed(m.sdrmicron.pack_rx_frame(iq))
        out.append(hw.read_samples(100))
        hw.feed(m.sdrmicron.pack_rx_frame(iq))
        out += [hw.read_samples(100), hw.read_samples(64),
                hw.read_samples(1)]
        hw.StopSamples()
        hw.close()
        return out, sink.msgs
    out, msgs = same(run)
    assert out[4] is True and out[3] == 960000.0
    assert out[-4] is None and out[-3].shape == (1, 100)


# ---------------------------------------------------------- multus, fifi
def test_multus_keyer_and_ptt_poll():
    def run(m):
        mu = m.multus
        ctrl = Recorder({"transfer_in": lambda addr, n: {
            mu.ADDR_PTT_POLL: b"\x01"}.get(addr, b"")})
        hw = mu.MultusHardware(ctrl=ctrl, keyer_speed=25, cw_tone=750.0)
        out = [hw.open()]
        for mode in ("CWU", "USB", "CWL", "AM"):
            hw.ChangeMode(mode)
        for name in ("keyer_speed", "cw_tone", "keyer_type", "paddle",
                     "spacing", "weight", "nope"):
            hw.immediate_change(name)
        out += [hw.poll_ptt(), hw.poll_ptt(),
                [mu.tone_index(f) for f in (300, 400, 600, 750, 800, 1000,
                                            1400)]]
        return out, ctrl.calls
    out, calls = same(run)
    assert out[1:3] == [1, None]
    assert ("transfer_out", PORT.multus.ADDR_SPEED, bytes([25])) in calls


def test_fifi_open_reads_versions_and_preamp():
    def run(m):
        fi = m.fifisdr

        def reply(request, index, n):
            if (request, index) == (fi.GET_FIFI_EXTRA, 0):
                return (12345).to_bytes(4, "little")
            if (request, index) == (fi.GET_FIFI_EXTRA, 1):
                return b"fifisdr-2.0\x00junk".ljust(20, b"\0")
            return b""
        ctrl = Recorder({"transfer_in": reply})
        hw = fi.FifiSdrHardware(ctrl=ctrl)
        out = [hw.open(), hw.svn_version, hw.fw_version]
        hw.set_preamp(0)
        hw.set_preamp(1)
        try:
            hw.set_preamp(3)
        except ValueError as e:
            out.append(str(e))
        return out, ctrl.calls
    out, calls = same(run)
    assert out[1:3] == [12345, "fifisdr-2.0"]
    assert calls[-1][0] == "transfer_out"


# ------------------------------------------------------- sdr8600, hamlib
def test_sdr8600_pacing_and_rounding():
    def run(m):
        t = [0.0]
        ser = Recorder()
        hw = m.sdr8600.Sdr8600Hardware(serial=ser, clock=lambda: t[0],
                                       transport=Sink())
        t[0] = 1.0
        out = [hw.open(), hw.invert_spectrum]
        t[0] = 1.05
        out.append(hw.ChangeFrequency(145_000_000, 145_000_000))
        out.append(hw.ChangeFrequency(145_010_000, 145_012_345))
        out.append(len(hw._pending))
        t[0] += 0.05
        hw.HeartBeat()
        out.append(hw.ChangeFrequency(50_000, 50_000))
        hw.ChangeBand("2")
        t[0] += 1.0
        hw.HeartBeat()
        hw.close()
        out.append([m.sdr8600.round_vfo(f) for f in
                    (123_456_789, 99_995_000, 7_005_000)])
        return out, [c for c in ser.calls if c[0] == "write"]
    out, writes = same(run)
    assert writes[0] == ("write", b"MD0\r") and out[-1][0] == 123_460_000


def test_hamlib_mode_mapping_and_poll_state_machine():
    def run(m):
        hl = m.hamlib_hw

        class FakeSock:
            def __init__(self):
                self.sent, self.rx = [], b""

            def sendall(self, b):
                self.sent.append(b.decode())

            def recv(self, n):
                out, self.rx = self.rx, b""
                if not out:
                    raise OSError("empty")
                return out

            def close(self):
                pass
        t = [0.0]
        sock = FakeSock()
        hw = hl.HamlibHardware(sock=sock, clock=lambda: t[0])
        out = [[hl.to_hamlib_mode(x) for x in ("CWL", "CWU", "DGT-U",
                                               "LSB", "AM")], hw.open()]
        hw.ChangeFrequency(7_074_000, 7_074_000)
        for k, rx in enumerate((b"", b"set_mode: USB 0|RPRT 0\n",
                                b"set_freq: 7074000|RPRT 0\n", b"", b"")):
            sock.rx = rx
            t[0] = 1.0 + k
            hw.HeartBeat()
        for rx in (b"get_freq:|Frequency: 7080000|RPRT 0\n",
                   b"get_mode:|Mode: CW|Passband: 500|RPRT 0\n",
                   b"get_freq:|Frequency: junk|RPRT 0\nnope RPRT -1\n"):
            hw.radio_mode = hw.quisk_mode
            sock.rx = rx
            hw.read_hamlib()
            out.append((hw.quisk_freq, hw.mode_from_radio,
                        hw.ReturnFrequency()))
        hw.ChangeMode("CWL")
        hw.close()
        return out, sock.sent
    out, sent = same(run)
    assert sent[:2] == ["|M USB 0\n", "|F 7074000\n"]
    assert out[-1][0] == 7_080_000 and out[-2][1] == "CWU"


# --------------------------------------------------------------- hl2 oob
def test_hl2_band_edges_per_mode():
    def run(m):
        return [m.hl2_oob.mode_band_edges(b, md)
                for b in ("160", "80", "40", "20", "10", "6", "2", "Audio")
                for md in ("CWU", "CWL", "USB", "LSB", "AM", "FM", "DGT-U")]
    out = same(run)
    assert out[2 * 7 + 2] == (7_000_000, 7_297_000)


def test_hl2_pa_gating():
    def run(m):
        hw = m.hl2_oob.HermesLite2OOBHardware()
        out = []
        for band, mode, f, want in (("40", "LSB", 7_100_000, True),
                                    ("40", "LSB", 7_001_000, True),
                                    ("40", "USB", 7_200_000, True),
                                    ("20", "CWU", 14_000_010, True),
                                    ("20", "CWU", 14_500_000, False)):
            hw.ChangeBand(band)
            hw.ChangeMode(mode)
            hw.ChangeFrequency(f, f)
            hw.power_amp_wanted = want
            hw.HeartBeat()
            out.append((hw.pa_enabled(), hw.ctl.get_byte(
                m.hl2_oob.PA_ROW, 2)))
        return out
    out = same(run)
    assert [o[0] for o in out] == [True, False, True, False, False]


# ------------------------------------------------------ softrock, sdr-iq
def test_si570_register_math():
    def run(m):
        sr = m.softrock
        fs = (7.05e6 * 4, 14.1e6 * 4, 28.5e6 * 4, 50e6 * 4, 1.8e6 * 4,
              28.2e6, 56.4e6, 114e6)
        out = [(sr.si570_divider_plan(f), sr.si570_registers(f),
                sr.si570_decode(sr.si570_registers(f))) for f in fs]
        try:
            sr.si570_divider_plan(1e3)
        except ValueError as e:
            out.append(str(e))
        return out
    out = same(run)
    assert all(abs(dec - f) < 1.0 for (_, _, dec), f in
               zip(out[:3], (7.05e6 * 4, 14.1e6 * 4, 28.5e6 * 4)))


def test_softrock_hardware_writes_registers():
    def run(m):
        tr = Recorder()
        hw = m.hw.get_hardware("softrock")(transport=tr)
        out = [hw.open()]
        for f in (7_050_000, 14_074_000, 28_500_000):
            out.append(hw.ChangeFrequency(f, f))
        return out, tr.calls
    out, calls = same(run)
    assert len(calls) == 3
    assert abs(PORT.softrock.si570_decode(calls[0][1]) - 4 * 7_050_000) < 1.0


def test_sdriq_message_framing_and_framer():
    def run(m):
        sq = m.sdriq
        out = [sq.set_frequency(f, ch) for f in (7_050_000, 30e6)
               for ch in (0, 1)]
        out += [sq.set_state(True), sq.set_state(False),
                sq.set_output_rate(37_793), sq.build_message(1, b"\x01\x00"),
                sq.build_control(0x0018, b"\x81\x02")]
        fr = sq.SdriqFramer()
        resp = sq.build_message(3, struct.pack("<H", 0x0018) + b"\x81\x02")
        iq = np.arange(4096, dtype=np.int16) - 2048
        data = struct.pack("<H", 0 | (sq.TYPE_DATA0 << 13)) + iq.tobytes()
        stream = resp + data + resp
        for i in range(0, len(stream), 777):
            fr.feed(stream[i:i + 777])
        out += [fr.responses, fr.take_samples(), fr.take_samples()]
        return out
    out = same(run)
    assert struct.unpack_from("<I", out[0], 5)[0] == 7_050_000
    assert out[-2].shape == (2048,) and len(out[-1]) == 0


def test_sdriq_hardware_control_flow():
    def run(m):
        t = Sink()
        hw = m.hw.get_hardware("sdriq")(transport=t)
        out = [hw.open()]
        hw.StartSamples()
        out.append(hw.ChangeFrequency(14_100_000, 14_050_000))
        hw.StopSamples()
        out += [hw.VarDecimGetChoices(), [hw.VarDecimSet(i) for i in
                                          range(len(hw.VarDecimGetChoices()))],
                hw.read_samples(16)]
        return out, t.msgs
    out, msgs = same(run)
    assert out[3][2] == 37793.0 and len(msgs) >= 4


# --------------------------------------------------------------- hiqsdr
def test_hiqsdr_control_packets():
    def run(m):
        hq = m.hiqsdr
        out = []
        for fw in (0, 1, 3):
            ctl = hq.HiqsdrControl(firmware=fw)
            ctl.rx_freq, ctl.tx_freq, ctl.tx_level = 7_020_000.0, \
                7_025_000.0, 200
            ctl.set_key_down(True)
            ctl.attenuator, ctl.ant, ctl.sidetone = 0x12, 1, 77
            ctl.set_rate(960_000.0)
            out.append(ctl.packet())
            ctl.set_key_down(False)
            ctl.set_vna(1e6, 11e6, 101)
            out.append(ctl.packet())
        out.append([hq.tune_phase(f) for f in (0.0, 7_020_000.0, 61.44e6,
                                                122.88e6)])
        for rate in (48_000.0, 96_000.0, 192_000.0, 960_000.0, 100.0):
            try:
                out.append(hq.decimation_for_rate(rate))
            except ValueError as e:
                out.append(str(e))
        return out
    out = same(run)
    assert len(out[0]) == 14 and len(out[2]) == 22 and out[2][:2] == b"St"
    assert out[-2] == (0b00, 16)


def test_hiqsdr_hardware_ack_cycle_and_vna():
    def run(m):
        tr = LoopTransport()
        hw = m.hiqsdr.HiqsdrHardware(transport=tr)
        out = [hw.open()]
        hw.HeartBeat()
        out.append(hw.acked)
        hw.HeartBeat()
        out.append(hw.ChangeFrequency(7_100_000, 7_050_000))
        out.append(hw.acked)
        hw.OnButtonPTT(True)
        hw.OnButtonPTT(False)
        out += [hw.VarDecimGetChoices(), hw.VarDecimSet(1),
                hw.SetVNA(vna_start=1e6, vna_stop=11e6, vna_count=101),
                hw.SetVNA(key_down=True)]
        stale = m.hiqsdr.HiqsdrHardware(transport=LoopTransport(
            reply=b"S" + b"\x00" * 21))
        stale.open()
        stale.HeartBeat()
        out.append((stale.acked, len(stale.transport.sent)))
        return out, tr.sent
    out, sent = same(run)
    assert out[1] is True and out[3] is False
    assert out[-1] == (False, 2)


# --------------------------------------------------------------- hermes
def test_hermes_register_block_and_bit_api():
    def run(m):
        ctl = m.hermes.HermesControl()
        ctl.set_rate(192000)
        ctl.set_n_receivers(4)
        ctl.set_tx_freq(14_100_000)
        for rx in range(4):
            ctl.set_rx_freq(rx, 14_050_000 + 1000 * rx)
        ctl.set_tx_level(63)
        ctl.set_rx_gain(20)
        ctl.set_byte(9, 1, 0x55)
        ctl.set_bit(0, 2, True)
        ctl.set_bit(10, 31, True)
        groups = [ctl.ctl_group(r, mox) for r in range(17)
                  for mox in (False, True)]
        return (groups, ctl.ctl_sequence(20, start_row=3, mox=True),
                ctl.get_byte(9, 1), ctl.get_byte(0, 4))
    groups, _, b91, b04 = same(run)
    assert groups[0][0] == 0 and groups[3][0] == (1 << 1) | 1
    assert b91 == 0x55 and b04 & 0x04


def test_hermes_discovery_start_and_round_robin():
    def run(m):
        hc = m.hermes.HermesControl
        reply = b"\xEF\xFE\x02" + bytes.fromhex("aabbccddeeff") + bytes([28,
                                                                          6])
        tr = LoopTransport(reply=reply)
        hw = m.hermes.HermesHardware(transport=tr)
        out = [hc.discovery_packet(), hc.parse_discovery_reply(reply),
               hc.start_packet(), hc.start_packet(iq=True, bandscope=True),
               hc.stop_packet(), hw.open(),
               [hw.next_ctl_group(mox=k % 3 == 0) for k in range(40)],
               hw.ChangeFrequency(7_100_000, 7_050_000),
               hw.VarDecimGetChoices(), hw.VarDecimSet(2)]
        return out, tr.sent
    out, _ = same(run)
    assert out[1] == {"mac": "aa:bb:cc:dd:ee:ff", "version": 28, "board": 6}
    assert {g[0] >> 1 for g in out[6][:17]} == set(range(17))


def test_hermes_ready_handshake_wire_sequence():
    """StartSamples through states 0-9: two stops, four control frames,
    starts repeated until frames flow; then shutdown and resume."""
    class Radio(LoopTransport):
        def poll_ctl(self):                # nothing stale to drain
            return None

    def run(m):
        tr = Radio(flowing_after=3)
        hw = m.hermes.HermesHardware(transport=tr)
        hw.StartSamples()
        t0 = time.time()
        while not hw.start_seq.running and time.time() - t0 < 10.0:
            hw.is_ready()
        hw.StopSamples()
        while hw.start_seq.state != 23 and time.time() - t0 < 10.0:
            hw.start_seq.step()              # steps >= 2 ms apart
        parked = hw.start_seq.state
        hw.start_seq.resume()
        while not hw.start_seq.running and time.time() - t0 < 10.0:
            hw.is_ready()
        return tr.sent, parked, hw.recovery_stats()
    sent, parked, st = same(run)
    assert parked == 23 and st["start_state"] == 9
    assert st["start_retries"] >= 3
    assert sum(1 for p in sent if len(p) == 1032) == 8


def test_hl2_write_queue_and_txbuf_machines():
    def run(m):
        hm = m.hermes
        t = [0.0]
        wq = hm.Hl2WriteQueue(clock=lambda: t[0])
        wq.write(b"\x7d\x06\x10\x30\x01")
        groups = []
        for _ in range(60):                  # no ACK: 50 tries, timeout
            groups.append(wq.poll_tx(mox=False))
            t[0] += 0.021
        out = [groups, wq.stats()]
        wq.write(b"\x7d\x06\x10\x30\x02")
        out.append(wq.poll_tx(mox=True))
        for ack in (0x7F, 0x7E, 0x7D, 0x7D):
            wq.on_ack(bytes([(ack << 1) & 0xFF, 1, 2, 3, 4]))
            out.append((wq.stats(), wq.poll_tx()))
        try:
            wq.write(b"\x00")
        except ValueError as e:
            out.append(str(e))
        mon = hm.Hl2TxBufMonitor()
        for mox, c3 in ((False, 0), (True, 0), (True, 0x10), (True, 0x80),
                        (True, 0x10), (True, 0xFF), (True, 0x85),
                        (True, 0x05), (False, 0)):
            mon.step(mox, c3)
            out.append((mon.state, mon.errors))
        return out
    out = same(run)
    assert sum(g is not None for g in out[0]) == 50
    assert out[1]["timeouts"] == 1


def _metis_frame(seq, ctl0=b"\x00" * 5, ctl1=b"\x00" * 5):
    out = bytearray(1032)
    out[0:4] = b"\xef\xfe\x01\x06"
    out[4:8] = int(seq).to_bytes(4, "big")
    for sub, ctl in ((0, ctl0), (1, ctl1)):
        base = 8 + sub * 512
        out[base:base + 3] = b"\x7f\x7f\x7f"
        out[base + 3:base + 8] = ctl
    return bytes(out)


@pytest.mark.parametrize("kind", ["native", "python"])
def test_hermes_status_and_ack_routing_through_the_pumps(kind):
    """Crafted frames through the port's Metis pump surface PTT / CW /
    overrange bits and row data and latch ACKs; HeartBeat routes a fresh
    ACK to the write queue (tests/test_hermes_recovery.py)."""
    p = (pump.NativePump("metis") if kind == "native" else
         pump.UdpPump(native.MetisStream(n_rx=1, use_native=False)))
    p.start()
    sk = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        row0 = bytes([0b0000_0101, 0x01, 0x00, 0x42, 0x07])
        ack = bytes([(0x7D << 1) & 0xFF, 1, 2, 3, 4])
        sk.sendto(_metis_frame(0, row0, ack), p.local_addr)
        _wait(lambda: p.stats()["packets"] >= 1)
        st = p.hermes_status()
        assert (st["ptt"], st["cwkey"], st["overrange"]) == (1, 1, 1)
        assert st["h2pc"][:4] == bytes([0x01, 0x00, 0x42, 0x07])
        assert p.take_ack() == ack and p.take_ack() is None
        hw = PORT.hermes.HermesHardware()
        hw.pump = p
        hw.WriteQueue(b"\x7d\x06\x10\x30\x01")
        assert hw.hl2_queue.poll_tx() is not None
        sk.sendto(_metis_frame(1, row0, ack), p.local_addr)
        _wait(lambda: p.stats()["packets"] >= 2)
        hw.HeartBeat()
        assert not hw.hl2_queue.busy
        assert hw.recovery_stats()["writequeue_completed"] == 1
        assert p.stats()["seq_errors"] == 0
    finally:
        p.stop()
        if hasattr(p, "close"):
            p.close()
        sk.close()


def test_hermes_ready_handshake_against_a_live_radio():
    """A scripted radio ignores the first 3 Start packets, then streams
    Metis frames into the port's pump (start_pump)."""
    radio = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    radio.bind(("127.0.0.1", 0))
    radio.settimeout(0.05)
    hw = PORT.hermes.HermesHardware()
    sink = hw.start_pump()
    ctl = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    ctl.bind(("127.0.0.1", 0))
    ctl.setblocking(False)
    count = {"starts": 0, "stops": 0, "ctl": 0}
    run = [True]

    def serve():
        while run[0]:
            try:
                pkt, _ = radio.recvfrom(2048)
            except (socket.timeout, OSError):
                continue
            if len(pkt) == 1032:
                count["ctl"] += 1
            elif pkt[:3] == b"\xef\xfe\x04":
                key = "starts" if pkt[3] else "stops"
                count[key] += 1
                if key == "starts" and count["starts"] == 4:
                    for f in range(50):
                        radio.sendto(_metis_frame(f), sink)

    class Transport:
        def sendto(self, pkt):
            ctl.sendto(pkt, radio.getsockname())

        def poll_ctl(self):
            try:
                return ctl.recv(2048)
            except BlockingIOError:
                return None

    th = threading.Thread(target=serve, daemon=True)
    th.start()
    hw.transport = Transport()
    try:
        hw.StartSamples()
        _wait(lambda: hw.is_ready() and hw.start_seq.running)
        _wait(lambda: hw.pump.stats()["packets"] >= 50)
        assert count["stops"] >= 2 and count["ctl"] >= 4
        assert hw.recovery_stats()["start_retries"] >= 3
        assert hw.pump.stats()["seq_errors"] == 0
        assert hw.read_samples(50 * 126).shape == (1, 50 * 126)
    finally:
        run[0] = False
        th.join(timeout=2.0)
        hw.close()
        radio.close()
        ctl.close()


# ------------------------------------------------------------------ VNA
def test_vna_calibration_recovers_the_dut():
    def run(m):
        v = m.vna
        cfg = v.ScanConfig(1e6, 30e6, 51)
        f = cfg.freqs()
        z = 50.0 + 1.0 / (2j * np.pi * f * 100e-12)
        gamma = v.impedance_to_s11(z)

        def meas(g, e00=0.05 + 0.02j, e11=0.1 - 0.05j,
                 dt=0.9 * np.exp(0.3j)):
            return e00 + dt * g / (1.0 - e11 * g)
        vna = v.VNA(hardware=None, config=cfg)
        vna.store_standard("open", meas(np.ones_like(gamma)))
        vna.store_standard("short", meas(-np.ones_like(gamma)))
        vna.store_standard("load", meas(np.zeros_like(gamma)))
        vna.finish_calibration()
        rep = vna.report(meas(gamma))
        return (f, gamma, rep, vna.corrected_s11(meas(gamma)),
                v.s11_to_impedance(gamma), v.return_loss_db(gamma),
                v.swr(gamma))
    f, gamma, rep, _, _, _, _ = same(run)
    z = 50.0 + 1.0 / (2j * np.pi * f * 100e-12)
    assert np.max(np.abs(rep["s11"] - gamma)) < 1e-9
    assert np.max(np.abs(rep["impedance"] - z)) < 1e-6
    assert np.all(rep["swr"] >= 1.0)


def test_vna_scan_blocks_with_hiqsdr():
    def run(m):
        v = m.vna
        cfg = v.ScanConfig(1e6, 11e6, 11)
        tr = LoopTransport()
        hw = m.hiqsdr.HiqsdrHardware(transport=tr)
        vna = v.VNA(hw, cfg)
        vna.setup()
        pts = (np.linspace(0.1, 1.0, 11) * 2147483647
               * (0.5 + 0.5j)).astype(np.complex128)
        stream = np.concatenate([[0], pts, [0], pts * 0.5, [0]])
        return (hw.ctl.vna_count, tr.sent, vna.read_scan(stream),
                v.split_scan_blocks(stream, 11),
                v.normalize_raw(np.array([2147483647, -5])))
    count, _, scan, blocks, _ = same(run)
    assert count == 11 and len(blocks) == 2
    assert abs(scan[-1] - (0.25 + 0.25j)) < 1e-9       # the latest scan


# -------------------------------------------------------------- wideband
@pytest.mark.parametrize("striped", [False, True])
def test_wideband_plugin_from_the_native_blaster(striped):
    hw = get_hardware("wideband")(n_streams=2 if striped else 1,
                                  striped=striped, sample_rate=196.608e6)
    assert "wideband capture" in hw.open()
    addrs = hw.start_pump()
    try:
        n = 8 * native.WIDEBAND_PAIRS
        if striped:
            assert pump.blast_striped(addrs, 8, pace_pps=2000.0) == 8
        else:
            assert pump.blast(addrs[0], codec="wideband",
                              n_packets=8, pace_pps=2000.0) == 8
        _wait(lambda: hw.pump.available() >= n)
        blk = hw.read_samples(n)
        want = ((np.arange(n) % 8160) % 1024) / 2048.0
        np.testing.assert_allclose(blk[0].real, want, atol=1e-6)
        st = hw.pump.stats()
        assert st["seq_errors"] == 0 and st["ring_overruns"] == 0
    finally:
        hw.close()
    assert hw.pump is None and hw.read_samples(8) is None


# ----------------------------------------------------- a live HiQSDR Radio
@pytest.fixture
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _snr_db(ref, got) -> float:
    ref = np.asarray(ref, np.float64)
    err = np.asarray(got, np.float64) - ref
    return float(10 * np.log10(np.mean(ref ** 2)
                               / max(np.mean(err ** 2), 1e-30)))


def test_radio_receives_from_a_live_socket_like_the_reference(_one_thread):
    """Radio + hiqsdr hardware on the CPU, fed 1442-byte packets over a
    loopback socket (tests/test_pump.py): zero sequence errors, and each
    block of audio >= 80 dB against the JAX Radio fed the same packets."""
    fs = 48000.0
    radio = Radio(RadioConfig(sample_rate=fs, mode="USB", tune_hz=7000.0),
                  hardware="hiqsdr", device="cpu")
    jradio = JRadio(JRadioConfig(sample_rate=fs, mode="USB", tune_hz=7000.0),
                    hardware="hiqsdr")
    addrs = [r.hw.start_pump() for r in (radio, jradio)]
    radio.open()
    jradio.open()
    nblk = 8
    n = (nblk * radio.chain.block_in // 240 + 1) * 240
    voice = jsources.voice_like(fs, n, band=(300.0, 2400.0))
    voice *= 0.3 / np.abs(voice).max()
    iq = jsources.ssb_signal(voice, fs, carrier_hz=7000.0).astype(
        np.complex64)
    tx = native.HiqsdrStream()
    pkts = [tx.build(iq[k:k + 240]) for k in range(0, n, 240)]
    sk = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        for k in range(0, len(pkts), 16):
            for p in pkts[k:k + 16]:
                for a in addrs:
                    sk.sendto(p, a)
            for r in (radio, jradio):
                _wait(lambda r=r: r.hw.pump.stats()["packets"]
                      >= min(k + 16, len(pkts)))
        audio, jaudio = radio.run(blocks=nblk), jradio.run(blocks=nblk)
        st = radio.hw.pump.stats()
    finally:
        sk.close()
        radio.close()
        jradio.close()
    assert st["seq_errors"] == 0 and st["ring_overruns"] == 0, st
    assert st["native"] is True
    assert audio.shape == jaudio.shape and audio.shape[1] == nblk * 2048
    a = audio[0][2 * 2048:]
    assert np.sqrt(np.mean(a ** 2)) > 0.01
    for b in range(nblk):
        seg = slice(b * 2048, (b + 1) * 2048)
        snr = _snr_db(jaudio[0][seg], audio[0][seg])
        assert snr >= AUDIO_DB, (b, snr)
