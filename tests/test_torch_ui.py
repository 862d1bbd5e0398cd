"""The port's operator surfaces on the CPU, against the JAX package's copies
and after tests/test_webui.py, test_widgets.py, test_midi.py,
test_interop.py, test_stations.py, test_remote.py and test_stage_toggles.py:
the web UI's page and messages byte-identical, the state JSON of the port's
Radio equal to the reference Radio's, standard_panel's JSON identical, the
MIDI parser and controller, DX spots, the favourites file, the memory bank
and the station markers identical, the remote link's packets byte-identical
and its HMAC auth, and the Radio's station, repeater, web UI and MIDI
methods.  Every server binds 127.0.0.1 port 0; every read has a timeout."""

import json
import os
import socket
import struct
import time

import numpy as np
import pytest
import torch
from test_tci import WsClient

from quisk_tpu.app import interop as j_interop
from quisk_tpu.app import midi as j_midi
from quisk_tpu.app import remote as j_remote
from quisk_tpu.app import stations as j_stations
from quisk_tpu.app import webui as j_webui
from quisk_tpu.app import widgets as j_widgets
from quisk_tpu.app.config import RadioConfig as JRadioConfig
from quisk_tpu.app.config import Settings as JSettings
from quisk_tpu.app.radio import Radio as JRadio
from quisk_tpu.hw.base import Hardware as JHardware

from quisk_tpu_torch.app import interop, midi, remote, stations, webui, widgets
from quisk_tpu_torch.app.config import RadioConfig, Settings
from quisk_tpu_torch.app.radio import Radio
from quisk_tpu_torch.hw.base import Hardware

FS = 48000.0
WAIT_S = 10.0


@pytest.fixture(autouse=True)
def _one_thread():
    """Torch on one CPU thread (ROADMAP: multi-threaded cos/sin traps)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def wait_until(pred, timeout: float = WAIT_S) -> bool:
    t0 = time.monotonic()
    while not pred():
        if time.monotonic() - t0 > timeout:
            return False
        time.sleep(0.005)
    return True


class SilentHW(Hardware):
    def read_samples(self, n):
        return np.zeros((1, n), np.complex64)


class JSilentHW(JHardware):
    def read_samples(self, n):
        return np.zeros((1, n), np.complex64)


def _pair(**kw):
    """The port's Radio (CPU) and the reference's, same config, silent
    hardware."""
    cfg = {**dict(sample_rate=FS, tune_hz=7_050_000.0, agc=False), **kw}
    return (Radio(RadioConfig(**cfg), hardware=SilentHW(), device="cpu"),
            JRadio(JRadioConfig(**cfg), hardware=JSilentHW()))


class FakeRadio:
    def __init__(self):
        self.freq_hz = 7_050_000.0
        self.vfo_hz = 7_050_000.0
        self.calls = []

        class Cfg:
            mode = "USB"
            channels = 4
        self.cfg = Cfg()

    def set_frequency(self, hz):
        self.freq_hz = hz
        self.calls.append(("freq", hz))

    def set_mode(self, m):
        self.cfg.mode = m
        self.calls.append(("mode", m))

    def set_sub_rx(self, channel, freq_hz=None, mode=None, route=None):
        self.calls.append(("subrx", channel, freq_hz, mode, route))


def _recording(server):
    frames = []
    server._broadcast = frames.append
    return frames


def _recv_json(ws):
    end = time.monotonic() + WAIT_S
    while time.monotonic() < end:
        op, p = ws.recv_frame()
        if op == 0x1:
            return json.loads(p.decode())
    raise AssertionError("no text frame")


def _recv_spectrum(ws):
    end = time.monotonic() + WAIT_S
    while time.monotonic() < end:
        op, p = ws.recv_frame()
        if op == 0x2 and p[:1] == b"S":
            f0, df, sm = struct.unpack_from("<3xddf", p, 1)
            return f0, df, sm, np.frombuffer(p[24:], np.float32)
    raise AssertionError("no spectrum frame")


def _get(port, path="/"):
    s = socket.create_connection(("127.0.0.1", port), timeout=WAIT_S)
    try:
        s.sendall(f"GET {path} HTTP/1.1\r\nHost: x\r\n\r\n".encode())
        out = b""
        while True:
            chunk = s.recv(65536)
            if not chunk:
                return out
            out += chunk
    finally:
        s.close()


# ----------------------------------------------------------- web UI, bytes
def test_page_and_modes_equal_the_reference():
    assert webui._PAGE == j_webui._PAGE and webui.MODES == j_webui.MODES
    pages = []
    for mod in (webui, j_webui):
        ui = mod.WebUIServer(FakeRadio())
        port = ui.start()
        try:
            pages.append(_get(port))
        finally:
            ui.stop()
    assert pages[0] == pages[1]
    assert b"200 OK" in pages[0] and b"<canvas" in pages[0]
    for m in webui.MODES:
        assert m.encode() in pages[0]


def test_flags_page_equals_the_reference():
    r, jr = _pair()
    bodies = []
    for x, mod in ((r, webui), (jr, j_webui)):
        ui = mod.WebUIServer(x)
        port = ui.start()
        try:
            bodies.append(_get(port, "/flags?section=Sound"))
        finally:
            ui.stop()
    assert bodies[0] == bodies[1] and b"application/json" in bodies[0]


def test_spectrum_and_multirx_frames_equal_the_reference():
    rng = np.random.default_rng(5)
    trace = rng.uniform(-140.0, -20.0, (6, 1024)).astype(np.float32)
    offs = np.array([0.0, 4e4, -3e4, 1e4, 9e4, -9e4])
    sent = []
    for mod in (webui, j_webui):
        ui = mod.WebUIServer(FakeRadio())
        frames = _recording(ui)
        ui.send_spectrum(7e6, 93.75, trace[0], smeter_db=-73.0)
        ui.on_command('{"cmd": "zoom", "value": 4, "center": 7040000}')
        ui.send_spectrum(7e6, 93.75, trace[0], smeter_db=-73.0)
        ui.send_spectrum(7e6, 93.75, trace[1], raw=True)
        ui.send_multirx(7_050_000.0, 192000.0, trace, offs)
        sent.append(frames)
    assert sent[0] == sent[1] and len(sent[0]) == 4 + 5


def test_state_and_command_frames_equal_the_reference():
    sent = []
    for mod in (webui, j_webui):
        fake = FakeRadio()
        ui = mod.WebUIServer(fake)
        frames = _recording(ui)
        for text in ('{"cmd": "freq", "value": 7074000}',
                     '{"cmd": "mode", "value": "LSB"}',
                     '{"cmd": "subrx", "channel": 2, "freq": 7060000, '
                     '"mode": "AM", "route": "left"}',
                     '{"cmd": "mode", "value": "NOPE"}', "{nope",
                     '{"cmd": "freq"}', '{"cmd": 7}', "[]",
                     '{"cmd": "zoom", "value": 2}',
                     '{"cmd": "zoom", "value": 0.5}',
                     '{"cmd": "widget", "id": "x", "event": "press"}'):
            ui.on_command(text)
        sent.append((frames, fake.calls))
    assert sent[0] == sent[1]


def test_radio_state_json_equals_the_reference(tmp_path):
    """The state the page draws (with the widget tree, the stages and the
    station markers) from the port's Radio equals the reference Radio's."""
    r, jr = _pair(channels=3, nr=True, auto_notch=True)
    for x in (r, jr):
        x.set_band("40")
        x.set_sub_rx(1, freq_hz=x.vfo_hz + 4000.0, mode="AM", route="left")
        x.set_rit(120.0)
        x.set_volume(0.4)
        fav = x.enable_favorites()
        fav.add("netA", x.vfo_hz + 6000.0, "LSB", "a net")
        x.save_memory()
        x.set_stage("nr", False)
    a = webui.WebUIServer(r).state_dict()
    b = j_webui.WebUIServer(jr).state_dict()
    assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)
    assert a["stations"] and a["stages"]["nr"] is False
    assert [w["name"] for w in a["widgets"]][:2] == ["freq", "entry"]


def test_standard_panel_json_equals_the_reference():
    r, jr = _pair(channels=2, nr=True, auto_notch=True)
    a, b = widgets.standard_panel(r), j_widgets.standard_panel(jr)
    assert json.dumps(a.to_json()) == json.dumps(b.to_json())
    for wid, event, kw in (("freq", "digit", {"index": 4, "up": True}),
                           ("mode", "press", {"button": "mode.AM"}),
                           ("Vol", "set", {"value": 40}),
                           ("Split", "press", {}),
                           ("NR2", "press", {})):
        assert a.dispatch(wid, event, **kw) == b.dispatch(wid, event, **kw)
        assert json.dumps(a.to_json()) == json.dumps(b.to_json()), wid
    assert r.freq_hz == jr.freq_hz and r.cfg.mode == jr.cfg.mode == "AM"
    assert r.volume == jr.volume and r.split_rxtx == jr.split_rxtx == 1
    assert r.stage_states() == jr.stage_states()


# ------------------------------------------------- web UI, behaviour (live)
def test_control_round_trip_and_malformed_input():
    fake = FakeRadio()
    ui = webui.WebUIServer(fake)
    port = ui.start()
    try:
        ws = WsClient(port, path="/ws")
        st = _recv_json(ws)
        assert st["freq"] == 7_050_000.0 and st["channels"] == 4
        ws.send_text(json.dumps({"cmd": "freq", "value": 7_074_000}))
        assert _recv_json(ws)["freq"] == 7_074_000.0
        ws.send_text("{nope")
        ws.send_text(json.dumps({"cmd": "mode", "value": "NOT_A_MODE"}))
        ws.send_text(json.dumps({"cmd": "mode", "value": "LSB"}))
        assert _recv_json(ws)["mode"] == "LSB"
        assert wait_until(lambda: ui.n_clients == 1)
        row = np.linspace(-140.0, -20.0, 256).astype(np.float32)
        ui.send_spectrum(7_000_000.0, 93.75, row, smeter_db=-73.0)
        f0, df, sm, got = _recv_spectrum(ws)
        assert (f0, df) == (7_000_000.0, 93.75) and abs(sm + 73.0) < 1e-4
        assert np.array_equal(got, row)
        ws.s.close()
    finally:
        ui.stop()


def test_radio_webui_integration():
    radio = Radio(RadioConfig(sample_rate=FS, audio_block=2048, mode="USB",
                              tune_hz=10000.0), hardware="sim", device="cpu")
    radio.hw.tone_hz = 10300.0
    radio.open()
    try:
        ws = WsClient(radio.enable_webui(), path="/ws")
        assert _recv_json(ws)["mode"] == "USB"
        assert wait_until(lambda: radio.webui.n_clients == 1)
        radio.run(blocks=radio.graph.blocks_per_refresh + 1)
        f0, df, sm, row = _recv_spectrum(ws)
        assert row.shape == (1024,) and np.all(np.isfinite(row))
        assert np.array_equal(row, radio.graph.waterfall[-1][0])
        assert abs(f0 + df * int(np.argmax(row)) - 10300.0) < 3 * df
        ws.send_text(json.dumps({"cmd": "freq", "value": 12000}))
        assert wait_until(lambda: radio.freq_hz == 12000.0)
        ws.send_text(json.dumps({"cmd": "volume", "value": 0.3}))
        assert wait_until(lambda: radio.volume == 0.3)
        ws.send_text(json.dumps({"cmd": "band", "value": "40"}))
        assert wait_until(lambda: radio.vfo_hz == 7_150_000)
        ws.s.close()
    finally:
        radio.close()
    assert radio.webui is None


def test_multirx_webui_protocol_drive():
    """A 4-channel radio driven from the browser protocol: sub-RX config,
    one 'M' row a sub-receiver, the DGT-IQ tap, zoom."""
    cfg = RadioConfig(sample_rate=192000.0, channels=4, audio_block=512,
                      mode="USB", tune_hz=5000.0)
    radio = Radio(cfg, hardware="sim", device="cpu")
    radio.hw.tone_hz = 5300.0
    radio.open()
    try:
        ws = WsClient(radio.enable_webui(), path="/ws")
        st = _recv_json(ws)
        assert st["channels"] == 4 and len(st["subrx"]) == 3
        ws.send_text(json.dumps({"cmd": "subrx", "channel": 1,
                                 "freq": radio.vfo_hz + 40000, "mode": "AM",
                                 "route": "left"}))
        _recv_json(ws)
        ws.send_text(json.dumps({"cmd": "subrx", "channel": 2,
                                 "freq": radio.vfo_hz - 30000,
                                 "mode": "DGT_IQ", "route": "off"}))
        sub = {s["channel"]: s for s in _recv_json(ws)["subrx"]}
        assert sub[1]["mode"] == "AM" and sub[2]["mode"] == "DGT_IQ"
        assert wait_until(lambda: radio.webui.n_clients == 1)
        radio.run(blocks=radio.graph.blocks_per_refresh + 1)
        rows = {}
        end = time.monotonic() + WAIT_S
        while set(rows) != {1, 2, 3} and time.monotonic() < end:
            op, p = ws.recv_frame()
            if op == 0x2 and p[:1] == b"M":
                ch, _, f0, df = struct.unpack_from("<BHdd", p, 1)
                rows[ch] = (f0, df, np.frombuffer(p[20:], np.float32))
        f0, df, row = rows[1]
        assert abs(f0 + df * len(row) / 2 - (radio.vfo_hz + 40000)) < 2000
        assert np.iscomplexobj(radio.digital_output(2))
        ws.send_text(json.dumps({"cmd": "zoom", "value": 4,
                                 "center": radio.vfo_hz + 5300}))
        assert _recv_json(ws)["zoom"] == 4
        radio.run(blocks=radio.graph.blocks_per_refresh + 1)
        f0, df, sm, row = _recv_spectrum(ws)
        assert abs(df - cfg.sample_rate / radio.graph.pixels / 4) < 1e-9
        assert abs(f0 + df * int(np.argmax(row))
                   - (radio.vfo_hz + 5300)) < 5 * df
        ws.s.close()
    finally:
        radio.close()


def test_multirx_rows_fit_the_channel_byte():
    """A fault of the reference: the 'M' frame names its channel in one
    byte, and its send_multirx raised struct.error at channel 256, inside
    the radio's block loop, so a web UI on a 1024-channel Radio failed its
    first graph refresh.  The port streams sub-receivers 1..255."""
    trace = np.full((300, 1024), -100.0, np.float32)
    offs = np.zeros(300)
    ui = webui.WebUIServer(FakeRadio())
    frames = _recording(ui)
    ui.send_multirx(0.0, 960000.0, trace, offs)
    chans = [struct.unpack_from("<BHdd", f[4:], 1)[0] for f in frames]
    assert chans == list(range(1, 256))
    with pytest.raises(struct.error):
        j_webui.WebUIServer(FakeRadio()).send_multirx(0.0, 960000.0, trace,
                                                      offs)


def test_webui_ptt_spot_and_stage_commands():
    radio = Radio(RadioConfig(sample_rate=FS, mode="CWU", tune_hz=7000.0,
                              agc=True, nr=True, auto_notch=True),
                  hardware=SilentHW(), device="cpu")
    radio.enable_tx()
    srv = webui.WebUIServer(radio)
    st = srv.state_dict()
    assert st["tx"] is True and st["spot"] == -1.0
    srv.on_command('{"cmd": "spot", "value": 0.5}')
    assert srv.state_dict()["spot"] == 0.5
    srv.on_command('{"cmd": "ptt", "value": true}')
    assert radio.manual_ptt is True
    srv.on_command('{"cmd": "ptt", "value": false}')
    assert radio.manual_ptt is False
    srv.on_command('{"cmd":"stage","name":"nr","on":false}')
    assert radio.stage_states()["nr"] is False
    srv.on_command('{"cmd":"stage","name":"bogus","on":true}')
    names = [w["name"] for w in srv.state_dict()["widgets"]]
    assert "NR2" in names and "Notch" in names and "AGC" in names


# ------------------------------------------------------------------ widgets
def _widget_run(mod):
    out = []
    fd = mod.FrequencyDisplay("freq", out.append, freq=14_234_567)
    for ev, kw in (("digit", {"index": 2, "up": True}),
                   ("digit", {"index": 2, "up": False}),
                   ("release", {}), ("wheel", {"index": 1, "up": True})):
        fd.handle(ev, **kw)
        out.append((fd.freq, fd.label))
    fd.display(900)
    fd.handle("digit", index=3, up=False)
    out.append([fd.next_repeat_ms() for _ in range(30)])
    s = mod.Slider("Vol", "Vol %3d", 30, 0, 100, out.append)
    s.handle("set", value=250)
    s.set_dec_value(0.25)
    out.append((s.value, s.label, s.get_dec_value()))
    c = mod.CycleButton("NB", ["NB", "NB 1", "NB 2", "NB 3"], out.append)
    for ev in ("press", "press", "right", "dclick", "press"):
        c.handle(ev)
        out.append(c.to_json())
    g = mod.RadioGroup("mode", lambda grp: out.append(grp.get_label()),
                       ["CWL", "CWU", ["LSB", "USB"], "AM"], default="CWU")
    for b in ("mode.AM", "mode.LSB", "mode.LSB"):
        g.handle("press", button=b)
    out.append(g.to_json())
    bf = mod.BitField("reg", 8, value=0b1010, command=out.append)
    bf.handle("bit", bit=0)
    e = mod.FreqEntry("entry", 100_000, 30_000_000, 7_000_000)
    for t in ("14.2305", "7 100 000", "-5", "99999999999"):
        e.handle("enter", text=t)
        out.append(e.freq)
    e.handle("spin", khz=7100)
    rb = mod.RepeatButton("Up", out.append, out.append)
    rb.handle("press")
    out.append([rb.next_repeat_ms() for _ in range(3)])
    rb.handle("release")
    p = mod.WidgetPanel()
    for w in (fd, s, c, bf, e, rb):
        p.add(w)
    out.append(p.to_json())
    out.append([mod.freq_format(f) for f in (7, 7210, 14_234_500, -1_000)])
    return json.loads(json.dumps(out, default=lambda o: type(o).__name__))


def test_widget_semantics_equal_the_reference():
    assert _widget_run(widgets) == _widget_run(j_widgets)


def test_frequency_display_digit_rules():
    fired = []
    fd = widgets.FrequencyDisplay("freq", fired.append, freq=14_234_567)
    fd.handle("digit", index=2, up=True)
    assert fd.freq == 14_234_600
    fd.handle("digit", index=2, up=False)
    assert fd.freq == 14_234_500 and fd.label == "14 234 500 Hz"
    fd.display(900)
    fd.handle("digit", index=3, up=False)
    assert fd.freq == 100 and len(fired) == 3
    fd.handle("release")
    fd.handle("wheel", index=1, up=True)
    assert fd.freq == 110 and fd.next_repeat_ms() is None


def test_cycle_button_and_radio_group():
    got = []
    c = widgets.CycleButton("NB", ["NB", "NB 1", "NB 2", "NB 3"], got.append)
    for _ in range(4):
        c.handle("press")
    assert c.index == 0 and not c.down
    c.handle("right")
    assert c.index == 3 and c.direction == -1
    sel = []
    g = widgets.RadioGroup("mode", lambda grp: sel.append(grp.get_label()),
                           ["CWL", "CWU", ["LSB", "USB"], "AM"],
                           default="CWU")
    g.handle("press", button="mode.LSB")
    g.handle("press", button="mode.LSB")
    assert g.get_label() == "USB"
    assert [b.down for b in g.buttons].count(True) == 1


# --------------------------------------------------------------------- MIDI
MIDI_STREAMS = [bytes([0x90, 60, 100, 0x80, 60, 0, 0xB0, 7, 70]),
                bytes([0x90, 61, 10, 62, 20, 0x90, 61, 0]),
                bytes([0xF8, 0x90, 0x14, 0xFE, 100, 0xC0, 5, 0xE0, 1, 2,
                       0xB0, 1, 65, 1, 1, 0xF0, 1, 2, 3, 0xF7, 0x80, 1, 2])]


@pytest.mark.parametrize("k", range(len(MIDI_STREAMS)))
def test_midi_parser_equals_the_reference(k):
    data = MIDI_STREAMS[k]
    ours, ref = interop.MidiParser(), j_interop.MidiParser()
    a = [e for i in range(len(data)) for e in ours.feed(data[i:i + 1])]
    b = [e for i in range(len(data)) for e in ref.feed(data[i:i + 1])]
    assert [vars(e) for e in a] == [vars(e) for e in b]
    assert [vars(e) for e in interop.MidiParser().feed(data)] == [
        vars(e) for e in b]


def test_midi_control_map_equals_the_reference():
    calls = ([], [])
    for mod, out in ((interop, calls[0]), (j_interop, calls[1])):
        mc = mod.MidiControlMap()
        mc.bind_note(60, "ptt")
        mc.bind_cc(16, "tune")
        mc.on("ptt", lambda down, v, out=out: out.append(("ptt", down, v)))
        mc.on("tune", lambda _, d, out=out: out.append(("tune", d)))
        mc.dispatch(mod.MidiParser().feed(bytes([0x90, 60, 127, 0xB0, 16,
                                                 65, 0xB0, 16, 63,
                                                 0x80, 60, 0])))
    assert calls[0] == calls[1] and ("ptt", True, 127) in calls[0]


def _midi_radio():
    r = Radio(RadioConfig(sample_rate=FS, mode="USB", tune_hz=7_055_000.0,
                          agc=False), hardware=SilentHW(), device="cpu")
    r.open()
    return r


def test_midi_ptt_and_cw_key_drive_the_loop():
    r = _midi_radio()
    try:
        r.enable_midi()
        r.midi_in.feed(bytes([0x90, 0x14, 100]))
        r.run_once()
        assert r.manual_ptt is True
        r.midi_in.feed(bytes([0x90, 0x14, 0]))
        r.run_once()
        assert r.manual_ptt is False
        r.midi_in.feed(bytes([0x90, 0x15, 127]))
        r.run_once()
        assert r.manual_key is True
        r.midi_in.feed(bytes([0x80, 0x15, 0]))
        r.run_once()
        assert r.manual_key is False
    finally:
        r.close()
    assert r.midi_in is None


def test_midi_controller_moves_the_same_as_the_reference():
    """The same MIDI bytes through the port's Radio and the reference's:
    jog tune with the speed table and snapping, absolute knobs, a band
    note, slider jogs clamped at their ends."""
    r, jr = _pair(tune_hz=7_055_000.0)
    msgs = [bytes([0xB0, 1, 1]), bytes([0xB0, 1, 65]), bytes([0xB0, 2, 1]),
            bytes([0xB0, 7, 64]), bytes([0xB0, 3, 127]),
            bytes([0x90, 0x20, 1]), bytes([0xB0, 9, 1]) * 8,
            bytes([0xB0, 9, 100]) * 3, bytes([0x90, 0x16, 1]),
            bytes([0xB0, 8, 30])]
    states = ([], [])
    for x, out in ((r, states[0]), (jr, states[1])):
        ctl = x.enable_midi()
        ctl.bind_cc(1, "Tune +3")
        ctl.bind_cc(2, "Tune +6")
        ctl.bind_cc(3, "Tune")
        ctl.bind_cc(9, "Vol -9")
        ctl.bind_note(0x20, "Band 40")
        for m in msgs:
            x.midi_in.feed(m)
            x.midi_ctl.dispatch(x.midi_in.poll())
            out.append((x.freq_hz, x.vfo_hz, x.volume, x.muted,
                        getattr(x, "band", None), x.cfg.mode))
        x.close()
    assert states[0] == states[1]
    lo, hi = Radio.BAND_EDGES["40"]
    assert lo <= states[0][5][0] <= hi


def test_midi_pipe_transport_and_running_status():
    rfd, wfd = os.pipe()
    try:
        mi = midi.MidiInput(rfd)
        os.write(wfd, bytes([0x90, 0x14, 100, 0x14, 0]))
        assert [e.kind for e in mi.poll()] == ["note_on", "note_off"]
        assert mi.poll() == []
        mi.close()
        jm = j_midi.MidiInput(None)
        jm.feed(bytes([0x90, 0x14, 100]))
        assert [vars(e) for e in jm.poll()] == [
            vars(e) for e in interop.MidiParser().feed(
                bytes([0x90, 0x14, 100]))]
    finally:
        os.close(rfd)
        os.close(wfd)


# ------------------------------------------------------------ DX spots
SPOT_LINES = ["DX de W1AW:     14074.0  JA1XYZ       FT8 +03dB     0123Z",
              "DX de K3LR:      7005.5  OK1ABC       CW 25 wpm      1456Z",
              "DX de VE3NEA:   21074.0  ZL2AAA       FT8            1457Z",
              "DX de W1AW: 7015.0 DL1ABC nice sig 1223Z",
              "login: please enter your call", "", "DX de X: abc Y"]


def test_dx_spots_equal_the_reference():
    for line in SPOT_LINES:
        a, b = interop.parse_spot(line), j_interop.parse_spot(line)
        assert (a is None) == (b is None), line
        if a is not None:
            assert vars(a) == vars(b)
    ours, ref = interop.DxClusterClient("N0CALL"), j_interop.DxClusterClient(
        "N0CALL")
    assert ours.on_connect() == ref.on_connect() == b"N0CALL\r\n"
    data = ("Welcome\r\n" + "\r\n".join(SPOT_LINES) + "\r\n").encode()
    for i in range(0, len(data), 17):
        a = ours.feed(data[i:i + 17])
        b = ref.feed(data[i:i + 17])
        assert [vars(s) for s in a] == [vars(s) for s in b]
    assert [s.dx_call for s in ours.spots] == [
        "JA1XYZ", "OK1ABC", "ZL2AAA", "DL1ABC"]


# ------------------------------------------------------- stations
FAV_TEXT = ("my net|7210000|LSB|My net 2030 UTC every Thursday\n"
            "10m FM 1|29.620|FM|Fm local 10 meter repeater|-0.1|88.5\n"
            "bad line without fields\n"
            "2m rptr|146.940|FM|W1XYZ|-600|100.0\n")


def test_favourites_file_equals_the_reference(tmp_path):
    out = []
    for mod, name in ((stations, "ours.txt"), (j_stations, "ref.txt")):
        p = tmp_path / name
        p.write_text(FAV_TEXT)
        fav = mod.Favorites(str(p))
        fav.add("FT8 20m", 14_074_000, "USB", "digital watering hole")
        fav.move(3, -2)
        fav.delete(0)
        fav.save()
        out.append((p.read_bytes(), fav.repeater_dict(),
                    [vars(e) for e in mod.Favorites(str(p)).entries]))
    assert out[0] == out[1]
    assert out[0][1] == {29_620_000: (-0.1, 88.5),
                         146_940_000: (-600.0, 100.0)}


def test_favourites_hz_correction():
    p_entries = stations.Favorites()
    p_entries.add("x", 7_210_000, "LSB")
    assert p_entries.entries[0].freq_hz == 7_210_000


def test_memory_bank_equals_the_reference():
    ops = [("save", 14_200_000, "20", 14_100_000, 100_000, "USB"),
           ("save", 7_050_000, "40", 7_000_000, 50_000, "LSB"),
           ("save", 14_200_000, "20", 14_100_000, 100_000, "AM"),
           ("save", 3_700_000, "80", 3_750_000, -50_000, "LSB"),
           ("next", 7_050_000), ("next", 14_200_000), ("at", 3_700_000),
           ("at", 1.0), ("delete", 7_050_000), ("delete", 1.0),
           ("next", 0.0)]
    banks = (stations.MemoryBank(), j_stations.MemoryBank())
    for op in ops:
        res = []
        for mb in banks:
            if op[0] == "save":
                r = mb.save(*op[1:])
            elif op[0] == "next":
                r = mb.next_after(op[1])
            elif op[0] == "at":
                r = mb.at_freq(op[1])
            else:
                r = mb.delete(op[1])
            res.append(vars(r) if hasattr(r, "__dict__") else r)
        assert res[0] == res[1], op
    assert banks[0].to_list() == banks[1].to_list()
    again = stations.MemoryBank(banks[0].to_list())
    assert again.stations == banks[0].stations


def test_station_markers_equal_the_reference():
    rows = []
    for mod, imod in ((stations, interop), (j_stations, j_interop)):
        fav = mod.Favorites()
        fav.add("netA", 7_210_000, "LSB")
        fav.add("out-of-span", 29_620_000, "FM")
        mb = mod.MemoryBank()
        mb.save(7_100_000, "40", 7_000_000, 100_000, "USB")
        spot = imod.parse_spot("DX de W1AW: 7015.0 DL1ABC nice sig 1223Z")
        rows.append(mod.station_markers(6_900_000, 7_400_000, favorites=fav,
                                        memories=mb, dx_spots=[spot]))
    assert rows[0] == rows[1]
    assert [m["kind"] for m in rows[0]] == ["dx", "mem", "fav"]


def test_radio_memory_buttons_and_persistence(tmp_path):
    """The MemSave / MemNext / MemDelete buttons on both Radios over the
    same band moves, and the port's bank persisted through Settings (the
    reference's Settings file loads in the port)."""
    s, js = Settings(tmp_path / "s.json"), JSettings(tmp_path / "j.json")
    r = Radio(RadioConfig(sample_rate=FS, tune_hz=7_050_000.0, agc=False),
              hardware=SilentHW(), settings=s, device="cpu")
    jr = JRadio(JRadioConfig(sample_rate=FS, tune_hz=7_050_000.0,
                             agc=False), hardware=JSilentHW(), settings=js)
    seen = ([], [])
    for x, out in ((r, seen[0]), (jr, seen[1])):
        x.set_band("40")
        x.save_memory()
        x.set_band("20")
        x.save_memory()
        for step in ("next", "next", "recall", "delete"):
            if step == "next":
                x.next_memory()
            elif step == "recall":
                x.recall_memory(x.memories.stations[0].freq)
            else:
                x.delete_memory()
            out.append((x.band, x.freq_hz, x.vfo_hz, x.cfg.mode,
                        x.memories.to_list()))
    assert seen[0] == seen[1]
    s.save()
    js.save()
    r2 = Radio(RadioConfig(sample_rate=FS, tune_hz=7_050_000.0, agc=False),
               hardware=SilentHW(), settings=Settings(tmp_path / "s.json"),
               device="cpu")
    r3 = Radio(RadioConfig(sample_rate=FS, tune_hz=7_050_000.0, agc=False),
               hardware=SilentHW(), settings=Settings(tmp_path / "j.json"),
               device="cpu")
    assert r2.memories.to_list() == r3.memories.to_list() == (
        r.memories.to_list())
    assert len(r2.memories) == 1


def test_tune_favorite_and_markers():
    r, jr = _pair()
    out = []
    for x in (r, jr):
        fav = x.enable_favorites()
        fav.add("netA", 7_060_000, "LSB")
        fav.add("netB", 7_040_000, "")
        x.tune_favorite(0)
        a = (x.freq_hz, x.cfg.mode)
        x.tune_favorite(1)
        out.append((a, x.freq_hz, x.cfg.mode, x.station_markers()))
    assert out[0] == out[1]
    assert out[0][0] == (7_060_000, "LSB") and out[0][2] == "LSB"


class RptrHW(SilentHW):
    def __init__(self):
        super().__init__()
        self.tx = []

    def write_samples(self, iq):
        self.tx.append(np.array(iq))


def test_fm_repeater_shift_and_ctcss_on_key():
    """A favourite with a repeater offset: key-down shifts the TX dial by
    the offset and installs the CTCSS tone; key-up restores both."""
    hw = RptrHW()
    r = Radio(RadioConfig(sample_rate=FS, tune_hz=29_620_000.0, mode="FM",
                          agc=False), hardware=hw, device="cpu")
    r.open()
    r.enable_tx()
    fav = r.enable_favorites()
    fav.add("rptr", 29_620_000, "FM", offset_khz=-100, tone_hz=88.5)
    assert float(r.tx.ctcss_amp) == 0.0
    r.set_ptt(True)
    r.run_once()
    assert hw.tx_frequency == 29_620_000 - 100_000
    assert float(r.tx.ctcss_amp) > 0.0
    assert abs(float(r.tx.ctcss_word) * FS / (2 * np.pi) - 88.5) < 0.01
    assert len(hw.tx) == 1
    r.set_ptt(False)
    r.run_once()
    assert hw.tx_frequency == 29_620_000
    assert float(r.tx.ctcss_amp) == 0.0
    r.set_mode("USB")                        # not FM: no shift on keying
    r.set_ptt(True)
    r.run_once()
    assert hw.tx_frequency == 29_620_000
    r.close()


# ------------------------------------------------------------------ remote
def test_remote_packets_equal_the_reference():
    audio = (np.sin(np.linspace(0, 20, 480)) * 0.7).astype(np.float32)
    db = np.linspace(-140.0, -20.0, 256)
    for seq in (0, 7, 2 ** 32 + 3):
        assert remote.pack_sound(seq, audio) == j_remote.pack_sound(seq, audio)
        assert remote.pack_graph(seq, db) == j_remote.pack_graph(seq, db)
    pkt = remote.pack_sound(7, audio)
    s, d = remote.unpack_sound(pkt)
    js, jd = j_remote.unpack_sound(pkt)
    assert s == js == 7 and np.array_equal(d, jd)
    assert np.max(np.abs(d - audio)) <= 1.0 / 32767
    assert remote.unpack_graph(pkt) is None
    g = remote.unpack_graph(remote.pack_graph(1, db))
    assert np.max(np.abs(g[1] - db)) < 0.01
    ch = b"0123456789abcdef"
    assert remote.auth_response("s3", ch) == j_remote.auth_response("s3", ch)
    assert remote.verify_response("s3", ch, remote.auth_response("s3", ch))
    assert not remote.verify_response("s3", ch, remote.auth_response("x",
                                                                     ch))
    assert remote.MAGIC == j_remote.MAGIC
    assert remote.AUDIO_MAGIC == j_remote.AUDIO_MAGIC


def test_remote_control_auth_and_commands():
    srv = remote.RemoteRadioServer(secret="s3cret")
    port = srv.start()
    try:
        c = remote.ControlHeadClient("s3cret", "127.0.0.1", port)
        try:
            assert c.command("freq 14074000") == "14074000"
            assert c.command("freq") == "14074000"
            assert c.command("mode LSB") == "LSB"
            assert c.command("ptt 1") == "1" and srv.state["ptt"] is True
            assert c.command("nonsense") == "ERR unknown"
        finally:
            c.close()
        with pytest.raises(PermissionError):
            remote.ControlHeadClient("wrong", "127.0.0.1", port)
        jc = j_remote.ControlHeadClient("s3cret", "127.0.0.1", port)
        try:
            assert jc.command("mode") == "LSB"     # the reference's head
        finally:
            jc.close()
    finally:
        srv.stop()


def test_udp_sound_graph_round_trip_and_loss_counting():
    rx = remote.UdpStreamRx(timeout=WAIT_S)
    tx = remote.UdpStreamTx(("127.0.0.1", rx.port))
    try:
        audio = (np.sin(np.linspace(0, 20, 480)) * 0.7).astype(np.float32)
        tx.send_sound(audio)
        kind, data = rx.recv()
        assert kind == "sound" and np.max(np.abs(data - audio)) < 1e-3
        db = np.linspace(-140.0, -20.0, 256)
        tx.send_graph(db)
        kind, data = rx.recv()
        assert kind == "graph" and np.max(np.abs(data - db)) < 0.01
        tx.seq += 3
        tx.send_sound(audio)
        rx.recv()
        assert rx.lost == 3
    finally:
        rx.sock.close()
        tx.sock.close()


def test_app_package_holds_the_reference_modules():
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    ref = {p.name for p in (root / "quisk_tpu" / "app").glob("*.py")}
    ours = {p.name for p in (root / "quisk_tpu_torch" / "app").glob("*.py")}
    assert ref <= ours, ref - ours
    ref_io = {p.name for p in (root / "quisk_tpu" / "io").glob("*.py")}
    ours_io = {p.name for p in (root / "quisk_tpu_torch" / "io").glob("*.py")}
    assert ref_io <= ours_io, ref_io - ours_io
