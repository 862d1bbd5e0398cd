"""The port's CAT and TCI surfaces on the CPU, against the JAX package's
copies and after tests/test_cat.py, test_tci.py and test_split_rit.py: the
Flex-ZZ and K4 command -> reply transcripts identical, the ZZ pty and the
K4 TCP round trips, the RFC 6455 layer and the TCI stream frames
byte-identical, a scripted TCI client's transcript byte-identical, and the
Radio integrations: one shared CAT state across surfaces (which the port,
unlike the reference, keeps current when TCI or the web UI retunes), TCI
retune and tci_transmit_once TX IQ >= 80 dB against the reference Radio.
Every server binds 127.0.0.1 port 0; every socket read has a timeout."""

import os
import socket
import time

import numpy as np
import pytest
import torch
from test_tci import WsClient

from quisk_tpu.app import cat as j_cat
from quisk_tpu.app import rigctl as j_rigctl
from quisk_tpu.app import tci as j_tci
from quisk_tpu.app.config import RadioConfig as JRadioConfig
from quisk_tpu.app.radio import Radio as JRadio

from quisk_tpu_torch.app import cat, rigctl, tci
from quisk_tpu_torch.app.config import RadioConfig
from quisk_tpu_torch.app.radio import Radio
from quisk_tpu_torch.hw.base import Hardware

FS = 48000.0
B = 2048
TX_DB = 80.0
AUDIO_DB = 80.0
WAIT_S = 10.0


@pytest.fixture(autouse=True)
def _one_thread():
    """Torch on one CPU thread (ROADMAP: multi-threaded cos/sin traps)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def snr_db(ref, got) -> float:
    ref = np.asarray(ref, np.complex128)
    err = np.asarray(got, np.complex128) - ref
    return float(10 * np.log10(np.mean(np.abs(ref) ** 2)
                               / max(np.mean(np.abs(err) ** 2), 1e-30)))


def wait_until(pred, timeout: float = WAIT_S) -> bool:
    t0 = time.monotonic()
    while not pred():
        if time.monotonic() - t0 > timeout:
            return False
        time.sleep(0.005)
    return True


def _states():
    ours, ref = rigctl.RadioState(), j_rigctl.RadioState()
    for st in (ours, ref):
        st.freq, st.mode = 7_074_000, "USB"
    return ours, ref


def _fields(st) -> dict:
    return {k: v for k, v in vars(st).items()
            if k not in ("lock", "on_change")}


# ------------------------------------------------- transcripts, port vs ref
ZZ_SCRIPTS = {
    "vfo_and_step": ["ZZFA", "FA", "ZZFA00014074000", "ZZFA", "ZZAC06",
                     "ZZAD", "ZZAU", "ZZAU", "ZZAC", "ZZAC99", "FB",
                     "ZZFB00014080000", "ZZFB", "FA07", "ZZFA1"],
    "modes": ["MD", "ZZMD", "MD1", "MD", "ZZMD07", "MD", "ZZMD", "MD3",
              "ZZMD04", "MD9", "ZZMD99", "MD"],
    "info_ptt_meter": ["ZZIF", "IF", "ZZTX", "TX", "ZZTX", "ZZIF", "RX",
                       "ZZTX1", "ZZTX0", "ZZSM", "ID", "ZZID", "ID",
                       "ZZAG042", "ZZAG", "AG0", "AG", "ZZAR+030", "ZZAR",
                       "ZZAR-015", "ZZAR", "ZZQQ", "ZZPS", "ZZMU", "ZZRS",
                       "ZZAI", "ZZVE", "OI"],
    "split_rit": ["ZZSP", "ZZSP1", "ZZSW", "FR", "FT", "FT1", "FT0",
                  "ZZSP0", "RT1", "RU", "RU100", "RD", "RD0050", "ZZIF",
                  "RC", "RT0", "XT", "XT1", "ZZBS020", "ZZBS", "BS"],
}


@pytest.mark.parametrize("script", sorted(ZZ_SCRIPTS))
def test_flexzz_transcript_equals_the_reference(script):
    ours_st, ref_st = _states()
    ours = cat.FlexZZProtocol(ours_st, smeter=lambda: -73.0)
    ref = j_cat.FlexZZProtocol(ref_st, smeter=lambda: -73.0)
    for cmd in ZZ_SCRIPTS[script]:
        assert ours.handle(cmd) == ref.handle(cmd), cmd
        assert _fields(ours_st) == _fields(ref_st), cmd
    text = ";".join(ZZ_SCRIPTS[script]) + ";"
    for chunk in (text[:7], text[7:19], text[19:]):
        assert ours.feed(chunk) == ref.feed(chunk)


K4_SCRIPTS = {
    "vfo": ["FA", "FA07", "FA", "FA07074", "FA00007074500", "FA", "FB",
            "FB00014074000", "FB", "FA$", "FA$07", "FT", "FT1", "FT",
            "FT0"],
    "modes_filters": ["MD", "MD1", "MD", "MD3", "MD9", "MD$", "FW",
                      "FW0050", "FW", "IS", "DT", "CW", "KS", "LN"],
    "identity_meter_ptt": ["ID", "ID1", "RV", "OM", "AI", "AI1", "AI0",
                           "SB", "SM", "K3", "K31", "SM", "K3", "TX", "IF",
                           "RX", "IF", "QQ12", "Z"],
}


@pytest.mark.parametrize("script", sorted(K4_SCRIPTS))
def test_k4_transcript_equals_the_reference(script):
    ours_st, ref_st = _states()
    ours = cat.K4Protocol(ours_st, smeter=lambda: -60.0, cw_pitch=700.0)
    ref = j_cat.K4Protocol(ref_st, smeter=lambda: -60.0, cw_pitch=700.0)
    for cmd in K4_SCRIPTS[script]:
        assert ours.handle(cmd) == ref.handle(cmd), cmd
        assert _fields(ours_st) == _fields(ref_st), cmd
    text = ";".join(K4_SCRIPTS[script]) + ";"
    assert ours.feed(text[:11]) + ours.feed(text[11:]) == (
        ref.feed(text[:11]) + ref.feed(text[11:]))


def test_code_tables_equal_the_reference():
    for name in ("KENWOOD_CODE", "KENWOOD_MODE", "FLEX_CODE", "FLEX_MODE",
                 "ELECRAFT_CODE", "ELECRAFT_MODE", "_ZZAC_STEPS"):
        assert getattr(cat, name) == getattr(j_cat, name), name


def test_wsjtx_command_equals_the_reference(tmp_path):
    fake = tmp_path / "wsjtx"
    fake.write_text("#!/bin/sh\n")
    for cfg in ({"path_to_wsjtx": str(fake), "rig_name_wsjtx": "quisk_tpu",
                 "config_wsjtx": "ft8"},
                {"path_to_wsjtx": str(fake)},
                {"path_to_wsjtx": str(tmp_path / "nope")}, {}, None):
        assert cat.wsjtx_command(cfg) == j_cat.wsjtx_command(cfg)
    assert cat.wsjtx_command({"path_to_wsjtx": str(fake),
                              "rig_name_wsjtx": "quisk_tpu",
                              "config_wsjtx": "ft8"}) == [
        str(fake), "--rig-name", "quisk_tpu", "--config", "ft8"]


# --------------------------------------------- behaviour (tests/test_cat.py)
def test_flexzz_frequency_mode_and_step():
    p = cat.FlexZZProtocol()
    p.state.freq = 7_074_000
    assert p.handle("ZZFA") == "ZZFA00007074000;"
    assert p.handle("FA") == "FA00007074000;"
    assert p.handle("ZZFA00014074000") == ""
    assert p.state.freq == 14_074_000
    assert p.handle("ZZAC06") == ""
    p.handle("ZZAD")
    assert p.state.freq == 14_073_000
    p.handle("ZZAU")
    assert p.state.freq == 14_074_000
    p.state.mode = "CWU"
    assert p.handle("MD") == "MD3;" and p.handle("ZZMD") == "ZZMD04;"
    assert p.handle("MD1") == "" and p.state.mode == "LSB"
    assert p.handle("ZZMD07") == "" and p.state.mode == "DGT_U"


def test_flexzz_info_ptt_meter_and_identity():
    p = cat.FlexZZProtocol(smeter=lambda: -73.0)
    p.state.freq, p.state.mode = 7_000_000, "USB"
    info = p.handle("ZZIF")
    assert info.startswith("ZZIF00007000000") and info.endswith(";")
    assert p.handle("IF").startswith("IF00007000000")
    p.handle("TX")
    assert p.state.ptt is True and p.handle("ZZTX") == "ZZTX1;"
    p.handle("RX")
    assert p.state.ptt is False
    assert p.handle("ZZSM") == "ZZSM134;"
    assert p.handle("ID") == "ID019;"
    p.handle("ZZID")
    assert p.handle("ID") == "ID900;"
    assert p.handle("ZZQQ") == "?;"
    assert p.feed("ZZP") + p.feed("S;ZZMU;") == "ZZPS1;ZZMU0;"


def test_k4_protocol_commands():
    p = cat.K4Protocol(cw_pitch=600.0, smeter=lambda: -73.0)
    p.state.freq = 14_074_000
    assert p.handle("FA") == "FA00014074000;"
    assert p.handle("FA07") == "" and p.state.freq == 7_000_000
    assert p.handle("FA07074") == "" and p.state.freq == 7_074_000
    p.state.passband = 2800
    assert p.handle("FW") == "FW0280;"
    assert p.handle("CW") == "CW60;" and p.handle("SM") == "SM00;"
    p.handle("K31")
    assert p.handle("SM") == "SM0000;"
    p.handle("FT1")
    assert p.state.split is True
    assert p.handle("QQ12") == "QQ?;"


def _read_until(fd, want: int, pump=None) -> bytes:
    got = b""
    t0 = time.monotonic()
    while got.count(b";") < want and time.monotonic() - t0 < WAIT_S:
        if pump is not None:
            pump()
        try:
            got += os.read(fd, 256)
        except BlockingIOError:
            time.sleep(0.005)
    return got


def test_serialcat_pty_round_trip():
    sc = cat.SerialCat(public_name="", state=None)
    fd = os.open(sc.slave_name, os.O_RDWR | os.O_NOCTTY | os.O_NONBLOCK)
    try:
        os.write(fd, b"ZZFA00010136000;ZZFA;MD;")
        got = _read_until(fd, 2, pump=sc.process)
        assert got == b"ZZFA00010136000;MD2;"
        assert sc.state.freq == 10_136_000
    finally:
        os.close(fd)
        sc.close()


def test_serialcat_public_name_links_the_pty(tmp_path):
    link = tmp_path / "quisk_cat"
    sc = cat.SerialCat(public_name=str(link), state=None)
    try:
        assert os.path.islink(link)
        assert os.path.realpath(link) == os.path.realpath(sc.slave_name)
    finally:
        sc.close()
    assert not os.path.lexists(link)


def test_k4_server_over_tcp_shares_state():
    st = rigctl.RadioState()
    st.freq = 7_000_000
    srv = cat.K4Server(st, port=0)
    port = srv.start()
    try:
        s = socket.create_connection(("127.0.0.1", port), timeout=WAIT_S)
        try:
            s.sendall(b"ID;FA00014074000;FA;MD2;MD;")
            got = b""
            while got.count(b";") < 3:
                got += s.recv(256)
            assert got == b"ID017;FA00014074000;MD2;"
            assert st.freq == 14_074_000 and st.mode == "USB"
        finally:
            s.close()
    finally:
        srv.stop()


# ----------------------------------------------------- the Radio's surfaces
def _cfg(cls=RadioConfig, **kw):
    return cls(**{**dict(sample_rate=FS, audio_block=B, mode="USB",
                         tune_hz=10000.0, agc=True), **kw})


def test_radio_cat_surfaces_share_one_state():
    """A K4 client retunes; the serial ZZ client reads the same state; the
    serial port sets the mode back and the chain follows."""
    radio = Radio(_cfg(), hardware="sim", device="cpu")
    radio.hw.tone_hz = 13000.0
    radio.open()
    try:
        sc = radio.enable_cat_serial(public_name="")
        port = radio.enable_k4(port=0)
        assert radio.k4.state is sc.state is radio._cat_state()
        s = socket.create_connection(("127.0.0.1", port), timeout=WAIT_S)
        fd = os.open(sc.slave_name, os.O_RDWR | os.O_NOCTTY | os.O_NONBLOCK)
        try:
            s.sendall(b"FA00000012000;MD1;")
            assert wait_until(lambda: radio.freq_hz == 12000.0
                              and radio.cfg.mode == "LSB")
            os.write(fd, b"ZZFA;MD;")
            assert _read_until(fd, 2, pump=radio.run_once) == (
                b"ZZFA00000012000;MD1;")
            os.write(fd, b"MD2;")
            assert wait_until(lambda: (radio.run_once() is not None
                                       and radio.cfg.mode == "USB"))
            assert np.all(np.isfinite(radio.run(blocks=3)))
        finally:
            os.close(fd)
            s.close()
    finally:
        radio.close()
    assert radio.k4 is None and radio.cat_serial is None


def test_radio_cat_ptt_volume_band_and_rit_wiring():
    """CAT set-commands beyond freq / mode reach the radio: ZZTX latches
    PTT, ZZAG the volume, ZZBS the band, RU / RT / RC the RIT."""
    radio = Radio(_cfg(), hardware="sim", device="cpu")
    radio.open()
    try:
        p = cat.FlexZZProtocol(state=radio._cat_state())
        p.handle("ZZTX1")
        assert radio.cat_ptt is True
        p.handle("ZZTX0")
        assert radio.cat_ptt is False
        p.handle("ZZAG025")
        assert abs(radio.volume - 0.25) < 1e-9
        p.handle("ZZBS020")
        assert radio.band == "20" and radio.cfg.mode == "USB"
        assert radio.vfo_hz > 9_000_000
        p.handle("RU100")
        p.handle("RT1")
        assert radio.rit_on and radio.rit_hz == 100.0
        assert "+00100" in p.handle("ZZIF")
        p.handle("RC")
        assert radio.rit_hz == 0.0
    finally:
        radio.close()


class _Zeros(Hardware):
    def read_samples(self, n):
        return np.zeros((1, n), np.complex64)


def test_radio_split_through_cat():
    hw = _Zeros()
    r = Radio(RadioConfig(sample_rate=FS, tune_hz=7000.0, channels=2,
                          agc=False), hardware=hw, device="cpu")
    st = r._cat_state()
    st.set("split", True)
    assert r.split_rxtx and r.tx_freq_hz == r.freq_hz + 3000.0
    st.set("tx_freq", int(r.vfo_hz + 9000.0))
    assert r.tx_freq_hz == r.vfo_hz + 9000.0 and r.offsets[1] == 9000.0
    st.set("split", False)
    assert not r.split_rxtx


def test_cat_state_follows_a_retune_from_any_surface():
    """A fault of the reference: its CAT state keeps the dial a CAT client
    last set, so after a retune from TCI, the web UI, MIDI or a memory a
    CAT client (WSJT-X, a logger) reads a stale frequency and mode.  The
    port writes every retune into the shared state (without calling back
    into the radio)."""
    r = Radio(_cfg(), hardware="sim", device="cpu")
    jr = JRadio(_cfg(JRadioConfig), hardware="sim")
    ours = cat.FlexZZProtocol(state=r._cat_state())
    ref = j_cat.FlexZZProtocol(state=jr._cat_state())
    for x in (r, jr):
        x.set_frequency(11_500.0)               # not a CAT client
        x.set_mode("LSB")
    assert ours.handle("ZZFA") == "ZZFA00000011500;"
    assert ours.handle("MD") == "MD1;"
    assert ref.handle("ZZFA") == "ZZFA00000010000;"    # stale
    assert ref.handle("MD") == "MD2;"
    rig = Radio(_cfg(), hardware="sim", rigctl_port=0, device="cpu")
    try:
        rig.set_frequency(12_000.0)
        assert rig.rigctl.state.freq == 12_000
    finally:
        rig.close()


# ------------------------------------------------------- RFC 6455 and frames
@pytest.mark.parametrize("n", [0, 1, 125, 126, 127, 65535, 65536, 70000])
def test_ws_frames_equal_the_reference(n):
    data = np.random.default_rng(n).integers(0, 256, n, np.uint8).tobytes()
    for payload, op in ((data, None), (data, 0x9), ("x" * n, None)):
        enc = tci.ws_encode(payload, op)
        assert enc == j_tci.ws_encode(payload, op)
        assert tci.WsDecoder().feed(enc) == j_tci.WsDecoder().feed(enc)
    mask = b"\x01\x02\x03\x04"
    head = bytes([0x82, 0x80 | min(n, 126) if n < 65536 else 0xFF])
    if 126 <= n < 65536:
        head += n.to_bytes(2, "big")
    elif n >= 65536:
        head += n.to_bytes(8, "big")
    body = bytes(b ^ mask[i % 4] for i, b in enumerate(data))
    masked = head + mask + body
    ours, ref = tci.WsDecoder(), j_tci.WsDecoder()
    got_o = ours.feed(masked[:5]) + ours.feed(masked[5:])
    got_r = ref.feed(masked[:5]) + ref.feed(masked[5:])
    assert got_o == got_r == [(0x2, data)]


def test_accept_key_and_constants_equal_the_reference():
    for key in ("dGhlIHNhbXBsZSBub25jZQ==", "x", ""):
        assert tci._ws_accept_key(key) == j_tci._ws_accept_key(key)
    assert tci._ws_accept_key("dGhlIHNhbXBsZSBub25jZQ==") == (
        "s3pPLMBiTxaQ9kYGzzhZRbK+xOo=")
    for name in ("WS_GUID", "IQ_STREAM", "RX_AUDIO_STREAM", "TX_AUDIO_STREAM",
                 "TX_CHRONO", "LINEOUT_STREAM", "TCI_STREAM_DATA_BYTES",
                 "MODULATIONS", "TCI_FLOAT32"):
        assert getattr(tci, name) == getattr(j_tci, name), name


@pytest.mark.parametrize("kind", [tci.RX_AUDIO_STREAM, tci.TX_AUDIO_STREAM,
                                  tci.TX_CHRONO, tci.IQ_STREAM])
def test_stream_frames_equal_the_reference(kind):
    x = np.random.default_rng(kind).standard_normal(480).astype(np.float32)
    for ch in (1, 2):
        a = tci.pack_stream(1, 48000, x, kind, channels=ch)
        assert a == j_tci.pack_stream(1, 48000, x, kind, channels=ch)
        ua, ub = tci.unpack_stream(a), j_tci.unpack_stream(a)
        assert ua[:-1] == ub[:-1] and np.array_equal(ua[-1], ub[-1])
    f = tci.pack_audio_frame(1, 48000, x)
    assert f == j_tci.pack_audio_frame(1, 48000, x)
    rx, rate, typ, data = tci.unpack_audio_frame(f)
    assert (rx, rate, typ) == (1, 48000, tci.RX_AUDIO_STREAM)
    assert np.array_equal(data, x)


# --------------------------------------------- a scripted TCI client, both
TCI_SCRIPT = ["vfo:0,0,14074000;", "modulation:0,lsb;", "vfo:0,0;",
              "modulation:0;", "bogus_command:1;", "audio_samplerate:12000;",
              "audio_samplerate:48000;", "split_enable:0,true;",
              "split_enable:0;", "vfo:5,0,7000000;", "vfo:0,0,notanumber;",
              "trx:banana;", "dds:0,7100000;", "dds:0;", "rx_enable:1,true;",
              "rx_enable:1;", "trx_count;", "iq_samplerate:96000;",
              "audio_stream_sample_type:int16;",
              "audio_stream_sample_type:float32;", "audio_stream_samples:512;",
              "tx_stream_audio_buffering:50;", "start;",
              "vfo:0,0,70", "74000;trx:0,tr", "ue;", "trx:0;",
              "audio_stream_channels:1;", "audio_start:0;"]
TCI_SENTINEL = "vfo:1,1,123;"


def _tci_transcript(mod, clock_t):
    """Run TCI_SCRIPT against ``mod``'s server, then an RX audio block, a TX
    audio frame, get_mic with the injected clock and the trx release;
    returns every frame the client received, in order."""
    now = [0.0]
    srv = mod.TciServer(port=0, clock=lambda: now[0])
    port = srv.start()
    c = WsClient(port)
    frames = []

    def until(pred):
        while True:
            op, p = c.recv_frame()
            frames.append((op, p))
            if pred(op, p):
                return

    try:
        until(lambda op, p: p == b"start;")
        for msg in TCI_SCRIPT:
            c.send_text(msg)
        c.send_text(TCI_SENTINEL)
        until(lambda op, p: p == TCI_SENTINEL.encode())
        assert wait_until(lambda: srv.tx_client is not None)
        stereo = np.stack([np.linspace(-1, 1, 5000, dtype=np.float32),
                           np.ones(5000, np.float32)])
        srv.send_audio(stereo)
        inter = np.random.default_rng(7).standard_normal(512).astype(
            np.float32)
        c.send_binary(mod.pack_stream(0, 48000, inter,
                                      mod.TX_AUDIO_STREAM))
        assert wait_until(lambda: srv.tx_pending() >= 256)
        now[0] = clock_t
        mic = srv.get_mic(300)
        c.send_text("trx:0,false;")
        c.send_text(TCI_SENTINEL)
        until(lambda op, p: p == TCI_SENTINEL.encode())
        return frames, mic, srv.state
    finally:
        c.close()
        srv.stop()


@pytest.mark.parametrize("clock_t", [0.0, 1.0])
def test_tci_scripted_client_transcript_equals_the_reference(clock_t):
    ours, mic, st = _tci_transcript(tci, clock_t)
    ref, jmic, jst = _tci_transcript(j_tci, clock_t)
    assert ours == ref
    assert np.array_equal(mic, jmic)
    for name in ("vfo", "dds", "modulation", "rx_enable", "trx",
                 "split_enable", "iq_rate", "audio_rate"):
        assert getattr(st, name) == getattr(jst, name), name
    assert st.vfo[0][0] == 7_074_000 and st.split_enable
    kinds = [tci.unpack_stream(p)[4] for op, p in ours if op == 0x2]
    assert kinds.count(tci.RX_AUDIO_STREAM) == 2
    assert (tci.TX_CHRONO in kinds) == (clock_t > 0)


# --------------------------------------------- behaviour (tests/test_tci.py)
def test_tci_handshake_preamble_and_commands():
    srv = tci.TciServer(port=0)
    port = srv.start()
    try:
        c = WsClient(port)
        pre = c.recv_until("start;")
        assert any(p.startswith("protocol:esdr,1.4") for p in pre)
        assert "device:quisk_tpu;" in pre and "ready;" in pre
        c.send_text("vfo:0,0,14074000;")
        assert c.recv_until("vfo:0,0,14074000;")
        assert srv.state.vfo[0][0] == 14074000
        c.send_text("modulation:0;")
        assert c.recv_until("modulation:0,usb;")
        c.close()
    finally:
        srv.stop()


def test_tci_partial_commands_and_a_second_client():
    srv = tci.TciServer(port=0)
    port = srv.start()
    try:
        a, b = WsClient(port), WsClient(port)
        a.recv_until("start;")
        b.recv_until("start;")
        a.send_text("vfo:0,0,70")
        a.send_text("74000;trx:0,tr")
        a.send_text("ue;")
        assert a.recv_until("trx:0,true;")
        assert srv.state.vfo[0][0] == 7074000 and srv.state.trx[0]
        assert b.recv_until("vfo:0,0,7074000;")
        assert b.recv_until("trx:0,true;")
        a.close()
        b.close()
    finally:
        srv.stop()


def test_tci_rx_audio_negotiation_and_chunking():
    srv = tci.TciServer(port=0)
    port = srv.start()
    try:
        c = WsClient(port)
        c.recv_until("start;")
        c.send_text("audio_stream_channels:1;audio_samplerate:24000;"
                    "audio_start:0;")
        c.recv_until("audio_start:0;")
        n = tci.TCI_STREAM_DATA_BYTES // 4 + 100
        srv.send_audio(np.stack([np.ones(n, np.float32),
                                 np.zeros(n, np.float32)]))
        got = []
        while sum(d.size for d in got) < n:
            *_, typ, chans, data = tci.unpack_stream(c.recv_binary())
            assert typ == tci.RX_AUDIO_STREAM and chans == 1
            assert len(data) * 4 <= tci.TCI_STREAM_DATA_BYTES
            got.append(data)
        assert np.allclose(np.concatenate(got), 0.5)
        c.close()
    finally:
        srv.stop()


def test_tci_tx_audio_and_chrono_pacing():
    now = [0.0]
    srv = tci.TciServer(port=0, clock=lambda: now[0])
    port = srv.start()
    try:
        c = WsClient(port)
        c.recv_until("start;")
        c.send_text("trx:0,true;")
        c.recv_until("trx:0,true;")
        assert wait_until(lambda: srv.tx_client is not None)
        n = 256
        i = np.arange(n, dtype=np.float32) / n
        inter = np.empty(2 * n, np.float32)
        inter[0::2], inter[1::2] = i, -i
        c.send_binary(tci.pack_stream(0, 48000, inter, tci.TX_AUDIO_STREAM))
        assert wait_until(lambda: srv.tx_pending() >= n)
        mic = srv.get_mic(n + 64)
        assert np.allclose(mic.real[:n], i) and np.allclose(mic.imag[:n], -i)
        assert np.all(mic[n:] == 0)
        now[0] = 1.0
        srv.get_mic(16)
        assert tci.unpack_stream(c.recv_binary())[4] == tci.TX_CHRONO
        c.send_text("trx:0,false;")
        assert wait_until(lambda: srv.tx_client is None)
        assert srv.tx_pending() == 0
        c.close()
    finally:
        srv.stop()


def test_tci_malformed_commands_keep_the_connection():
    srv = tci.TciServer(port=0)
    port = srv.start()
    try:
        c = WsClient(port)
        c.recv_until("start;")
        for bad in ("vfo:5,0,7000000;", "vfo:0,0,notanumber;",
                    "trx:banana;", "audio_samplerate:12000;"):
            c.send_text(bad)
        c.send_text("vfo:0,0,7074000;")
        assert c.recv_until("vfo:0,0,7074000;")
        c.close()
    finally:
        srv.stop()


def test_tci_radio_retune_audio_and_transmit_equal_the_reference():
    """A TCI client retunes both Radios and listens to their RX audio
    (>= 80 dB apart a block); it claims trx, streams TX audio, and
    tci_transmit_once returns the same IQ (>= 80 dB)."""
    radios = [Radio(_cfg(), hardware="sim", device="cpu"),
              JRadio(_cfg(JRadioConfig), hardware="sim")]
    clients = []
    try:
        for r in radios:
            r.hw.tone_hz = 11000.0
            r.open()
            c = WsClient(r.enable_tci(port=0))
            clients.append(c)
            assert "vfo:0,0,10000;" in c.recv_until("start;")
            c.send_text("vfo:0,0,12000;modulation:0,lsb;audio_start:0;")
            c.recv_until("audio_start:0;")
            assert wait_until(lambda r=r: r.freq_hz == 12000.0
                              and r.cfg.mode == "LSB"
                              and r._cat_state() is not None)
        audio = [[], []]
        for _ in range(3):
            for k, (r, c) in enumerate(zip(radios, clients)):
                r.run_once()
                n = 0
                while n < B:
                    *_, typ, chans, data = tci.unpack_stream(c.recv_binary())
                    assert typ == tci.RX_AUDIO_STREAM and chans == 2
                    audio[k].append(data[0::2])
                    n += data.size // 2
        ours, ref = np.concatenate(audio[0]), np.concatenate(audio[1])
        assert snr_db(ref[B:], ours[B:]) >= AUDIO_DB
        tone = (0.3 * np.sin(2 * np.pi * 1000 / FS * np.arange(B))
                ).astype(np.float32)
        inter = np.repeat(tone, 2)
        iqs = []
        for r, c in zip(radios, clients):
            assert r.tci_transmit_once() is None          # no TX chain yet
            r.enable_tx()
            assert r.tci_transmit_once() is None          # trx not held
            c.send_text("trx:0,true;")
            c.recv_until("trx:0,true;")
            assert wait_until(lambda r=r: r.tci.tx_client is not None)
            c.send_binary(tci.pack_stream(0, 48000, inter,
                                          tci.TX_AUDIO_STREAM))
            assert wait_until(lambda r=r: r.tci.tx_pending() >= B)
            iqs.append(r.tci_transmit_once())
        assert iqs[0] is not None and np.max(np.abs(iqs[0])) > 1e-3
        assert snr_db(iqs[1], iqs[0]) >= TX_DB
    finally:
        for c in clients:
            c.close()
        for r in radios:
            r.close()
    assert radios[0].tci is None


# ------------------------- rigctld and CW keying (tests/test_interop.py)
class _RigClient:
    def __init__(self, port):
        self.s = socket.create_connection(("127.0.0.1", port), timeout=WAIT_S)
        self.f = self.s.makefile("rwb")

    def cmd(self, line, nlines=1):
        self.f.write((line + "\n").encode())
        self.f.flush()
        return [self.f.readline().decode().rstrip("\n") for _ in range(nlines)]

    def close(self):
        self.s.close()


RIG_SCRIPT = [("F 14074000", 1), ("f", 1), ("M USB 2400", 1), ("m", 2),
              ("M CW 500", 1), ("m", 2), ("T 1", 1), ("t", 1),
              ("V VFOB", 1), ("v", 1), ("\\dump_state", 21),
              ("\\chk_vfo", 1), ("Z 1", 1), ("S 1 VFOB", 1), ("s", 2),
              ("I 14080000", 1), ("i", 1)]


def test_rigctl_transcript_equals_the_reference():
    """The port's rigctld (ported with slice 7a) answers a WSJT-X-like
    session exactly as the reference's does, over real sockets."""
    replies = []
    for mod in (rigctl, j_rigctl):
        srv = mod.RigctlServer(port=0)
        port = srv.start()
        try:
            c = _RigClient(port)
            try:
                replies.append([c.cmd(line, n) for line, n in RIG_SCRIPT])
            finally:
                c.close()
            replies.append(_fields(srv.state))
        finally:
            srv.stop()
    assert replies[0] == replies[2] and replies[1] == replies[3]
    assert replies[0][1] == ["14074000"] and replies[0][5][0] == "CW"
    assert replies[0][10][0] == "0" and replies[0][12] == ["RPRT -11"]


def test_cw_keying_helpers_equal_the_reference():
    from quisk_tpu.app import cw as j_cw

    from quisk_tpu_torch.app import cw
    for text, wpm in (("e", 20.0), ("t", 20.0), ("a", 20.0),
                      ("cq de n0call", 25.0)):
        assert np.array_equal(cw.text_to_key_samples(text, wpm, FS),
                              j_cw.text_to_key_samples(text, wpm, FS))
    unit = round(1.2 / 20.0 * FS)
    assert np.sum(cw.text_to_key_samples("a", 20.0, FS)) == 4 * unit
    outs = []
    for mod in (cw, j_cw):
        jb = mod.KeyJitterBuffer(FS, delay_ms=20.0)
        jb.push(0.000, True)
        jb.push(0.060, False)
        jb.push(0.100, True)
        jb.push(0.112, False)
        outs.append(jb.render(int(0.2 * FS)))
    assert np.array_equal(outs[0], outs[1])
    on = np.where(outs[0][:int(0.09 * FS)] > 0.5)[0]
    assert abs(on[0] / FS - 0.020) < 1e-3
    assert abs((on[-1] - on[0] + 1) / FS - 0.060) < 1e-3


def test_radio_vfo_recenter_keeps_subrx_absolute():
    """A CAT tune that recenters the VFO keeps each sub-receiver's
    absolute frequency; one that leaves the passband is clamped and
    counted, as the reference's Radio does."""
    cfg = dict(sample_rate=48000.0, audio_block=2048, mode="USB",
               tune_hz=0.0, channels=3)
    for r in (Radio(RadioConfig(**cfg), hardware="sim", device="cpu"),
              JRadio(JRadioConfig(**cfg), hardware="sim")):
        r.open()
        try:
            r.set_frequency(7_050_000)
            r.set_sub_rx(1, freq_hz=7_060_000.0, mode="AM")
            r.set_sub_rx(2, freq_hz=7_070_000.0, mode="USB")
            r.set_frequency(7_080_000)
            assert r.vfo_hz == 7_080_000.0
            assert r.vfo_hz + r.offsets[1] == 7_060_000.0
            assert r.vfo_hz + r.offsets[2] == 7_070_000.0
            r.set_frequency(7_150_000)
            assert abs(r.offsets[1]) <= 0.5 * cfg["sample_rate"]
            assert r.status.snapshot().get("subrx_out_of_band", 0) >= 1
        finally:
            r.close()
