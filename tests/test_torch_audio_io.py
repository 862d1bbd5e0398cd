"""The port's audio devices on the CPU, against the JAX package's copies on
the same seeded inputs and after tests/test_audio_out.py,
test_ratematch_div.py, test_tx_runtime.py and test_status_profiling.py:
the rate matcher (outputs and servo fill trajectories sample for sample),
the sinks and sources, the player and the capture thread, Radio.play at
L = 1 / 2 / 4 / 8 (>= 90 dB against the reference Radio), and the live mic,
VOX and CQ keyer TX IQ (>= 80 dB against the reference Radio).  Clocks are
injected or waited on: nothing here asserts a wall-clock rate."""

import sys
import time

import numpy as np
import pytest
import torch

from quisk_tpu.app.config import RadioConfig as JRadioConfig
from quisk_tpu.app.radio import Radio as JRadio
from quisk_tpu.hw.base import Hardware as JHardware
from quisk_tpu.io import audio_in as j_audio_in
from quisk_tpu.io import audio_out as j_audio_out
from quisk_tpu.io import ratematch as j_ratematch

from quisk_tpu_torch.app.config import RadioConfig
from quisk_tpu_torch.app.radio import Radio
from quisk_tpu_torch.app.status import StatusBoard
from quisk_tpu_torch.hw.base import Hardware
from quisk_tpu_torch.io import audio_in, audio_out, ratematch, wav

FS = 48000.0
B = 2048
PLAY_DB = 90.0
TX_DB = 80.0
WAIT_S = 20.0


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


def wait_until(pred, timeout: float = WAIT_S) -> None:
    t0 = time.monotonic()
    while not pred():
        assert time.monotonic() - t0 < timeout, "timed out"
        time.sleep(0.005)


class FakeClock:
    """perf_counter / sleep stand-ins: sleeping advances the clock."""

    def __init__(self):
        self.t = 100.0
        self.slept = 0.0

    def perf_counter(self):
        return self.t

    def sleep(self, dt):
        self.t += dt
        self.slept += dt


# ------------------------------------------------------------ rate matching
@pytest.mark.parametrize("ratios", [(1.0,), (1.0 + 117e-6,), (0.99, 1.01),
                                    (44100.0 / 48000.0,),
                                    (48000.0 / 44100.0, 1.0, 0.5)])
def test_var_resampler_equals_the_reference(ratios):
    rng = np.random.default_rng(1)
    ours = ratematch.VarRateResampler(ratios[0])
    ref = j_ratematch.VarRateResampler(ratios[0])
    for k in range(12):
        x = rng.standard_normal(int(rng.integers(1, 3 * B)))
        r = ratios[k % len(ratios)]
        a, b = ours.process(x, r), ref.process(x, r)
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    assert ours.phase == ref.phase and np.array_equal(ours.hist, ref.hist)


@pytest.mark.parametrize("skew,dtype", [(1.0 + 200e-6, np.float64),
                                        (1.0 - 300e-6, np.float64),
                                        (1.0 + 200e-6, np.float32)])
def test_rate_servo_fill_trajectory_equals_the_reference(skew, dtype):
    rng = np.random.default_rng(0)
    ours = ratematch.RateServo(8 * B, kp=2e-3, ki=2e-5, dtype=dtype)
    ref = j_ratematch.RateServo(8 * B, kp=2e-3, ki=2e-5, dtype=dtype)
    x = rng.standard_normal(4 * B).astype(dtype)
    ours.feed(x)
    ref.feed(x)
    n_in = int(B * skew)
    for i in range(120):
        x = rng.standard_normal(n_in).astype(dtype)
        ours.feed(x)
        ref.feed(x)
        a, b = ours.read(B), ref.read(B)
        assert np.array_equal(a, b) and ours.fill == ref.fill, i
    assert (ours.underruns, ours.overruns) == (ref.underruns, ref.overruns)


def test_var_resampler_identity_ratio():
    rs = ratematch.VarRateResampler(1.0)
    x = np.sin(2 * np.pi * 1000.0 * np.arange(4 * B) / FS)
    y = np.concatenate([rs.process(x[i * B:(i + 1) * B]) for i in range(4)])
    n = min(len(y), len(x)) - 4
    assert np.max(np.abs(y[3:n] - x[:n - 3])[100:]) < 1e-6


def test_var_resampler_tone_fidelity_at_offset_ratio():
    ratio = 1.0 + 117e-6
    rs = ratematch.VarRateResampler(ratio)
    n = 32 * B
    x = np.sin(2 * np.pi * 1000.0 * np.arange(n) / FS)
    y = np.concatenate([rs.process(x[i * B:(i + 1) * B])
                        for i in range(n // B)])
    ref = np.sin(2 * np.pi * 1000.0 * (np.arange(len(y)) * ratio - 3.0) / FS)
    err = y[100:-100] - ref[100:len(y) - 100]
    assert np.sqrt(np.mean(err ** 2)) < 1e-4


def test_rate_servo_holds_fill_under_skew():
    servo = ratematch.RateServo(buffer_samples=8 * B, kp=2e-3, ki=2e-5)
    rng = np.random.default_rng(0)
    servo.feed(rng.standard_normal(4 * B))
    fills = []
    for _ in range(400):
        servo.feed(rng.standard_normal(int(B * (1.0 + 200e-6))))
        servo.read(B)
        fills.append(servo.fill)
    assert servo.underruns == 0 and servo.overruns == 0
    tail = np.asarray(fills[200:])
    assert np.all(tail > 0.2) and np.all(tail < 0.8)
    assert abs(np.mean(fills[-50:]) - np.mean(fills[200:250])) < 0.1


def test_io_package_exports_what_the_reference_does():
    import quisk_tpu.io as jio

    import quisk_tpu_torch.io as tio
    for name in ("native", "ratematch", "sources", "wav", "RateServo",
                 "VarRateResampler"):
        assert hasattr(jio, name) and hasattr(tio, name), name
    assert tio.RateServo is ratematch.RateServo


def test_status_board_aggregates_the_servo():
    sb = StatusBoard()
    servo = ratematch.RateServo(buffer_samples=1024)
    sb.attach("audio_out", servo)
    servo.read(64)                       # an underrun
    sb.count("fft_overrun")
    sb.count("fft_overrun")
    snap = sb.snapshot()
    assert snap["audio_out.underruns"] == 1 and snap["fft_overrun"] == 2
    assert "uptime_secs" in snap
    assert sb.healthy({"fft_overrun": 5})
    assert not sb.healthy({"fft_overrun": 1})


# -------------------------------------------------------------------- sinks
def test_clocked_sink_paces_by_its_clock(monkeypatch):
    clk = FakeClock()
    monkeypatch.setattr(audio_out, "time", clk)
    sink = audio_out.ClockedNullSink(FS)
    for _ in range(10):
        sink.write(np.zeros(2400, np.float32))    # 10 x 50 ms
    assert abs(clk.slept - 0.5) < 1e-9
    sink.close()


def test_wav_sink_bytes_equal_the_reference(tmp_path):
    x = 0.25 * np.sin(2 * np.pi * 1000 / FS * np.arange(4800)
                      ).astype(np.float32)
    for mod, name in ((audio_out, "ours.wav"), (j_audio_out, "ref.wav")):
        s = mod.make_sink(f"wav:{tmp_path / name}", FS)
        s.write(x[:2400])
        s.write(x[2400:])
        s.close()
    assert ((tmp_path / "ours.wav").read_bytes()
            == (tmp_path / "ref.wav").read_bytes())
    y, fs = wav.read_audio_wav(str(tmp_path / "ours.wav"))
    assert fs == FS and np.max(np.abs(y - x)) < 1e-3


def test_command_sink_pipes_float_pcm(tmp_path):
    out = tmp_path / "pcm.f32"
    s = audio_out.CommandSink([sys.executable, "-c",
                               "import sys; open(sys.argv[1], 'wb').write("
                               "sys.stdin.buffer.read())", str(out)], FS)
    x = np.arange(300, dtype=np.float32) / 300.0
    s.write(x[:100])
    s.write(x[100:])
    s.close()
    assert np.array_equal(np.fromfile(out, np.float32), x)


def test_make_sink_kinds():
    assert isinstance(audio_out.make_sink("null", FS),
                      audio_out.ClockedNullSink)
    with pytest.raises(ValueError):
        audio_out.make_sink("nope", FS)


class ListSink:
    def __init__(self):
        self.chunks = []
        self.closed = False

    def write(self, block):
        self.chunks.append(np.array(block))

    def close(self):
        self.closed = True


def test_player_hands_the_servo_output_to_the_sink():
    """What the player pushes reaches the sink as the servo resampled it,
    in order; a read short of a block is padded and counted."""
    sink = ListSink()
    player = audio_out.AudioPlayer(sink, FS, latency_ms=100.0, block=480)
    outs, feed = [], player.servo.rs.process

    def process(x, ratio=None):
        y = feed(x, ratio)
        outs.append(np.array(y))
        return y
    player.servo.rs.process = process
    tone = 0.1 * np.sin(2 * np.pi * 700 / FS * np.arange(6 * 512))
    for k in range(6):
        player.push(tone[k * 512:(k + 1) * 512].astype(np.float32))
    player.start()
    try:
        wait_until(lambda: len(player.servo.buf) == 0)
    finally:
        player.stop()
    st = player.stats()
    assert sink.closed and st["overruns"] == 0
    assert st["blocks_played"] == len(sink.chunks)
    assert all(c.size == 480 for c in sink.chunks)
    got = np.concatenate(sink.chunks)
    want = np.concatenate(outs)
    assert np.array_equal(got[:want.size].astype(np.float64), want)
    assert not np.any(got[want.size:])


# ------------------------------------------------------------------ sources
def test_file_mic_reads_equal_the_reference(monkeypatch, tmp_path):
    clk = FakeClock()
    monkeypatch.setattr(audio_in, "time", clk)
    monkeypatch.setattr(j_audio_in, "time", clk)
    data = np.random.default_rng(3).standard_normal(5000).astype(np.float32)
    p = tmp_path / "mic.wav"
    wav.write_audio_wav(str(p), 0.5 * data / np.max(np.abs(data)), FS)
    for src in (data, f"wav:{p}"):
        ours = audio_in.make_source(src, FS)
        ref = j_audio_in.make_source(src, FS)
        for n in (512, 4000, 1, 3000, 512):
            assert np.array_equal(ours.read(n), ref.read(n))
    one = audio_in.ClockedFileMic(data, FS, loop=False)
    assert one.read(4096).size == 4096 and one.read(4096).size == 904
    assert one.read(16).size == 0


def test_sources_pace_by_their_clock(monkeypatch):
    clk = FakeClock()
    monkeypatch.setattr(audio_in, "time", clk)
    s = audio_in.SilenceSource(16000.0)
    for _ in range(5):
        assert not np.any(s.read(1600))
    assert abs(clk.slept - 0.5) < 1e-9
    m = audio_in.ClockedFileMic(np.ones(100, np.float32), 16000.0)
    clk.slept = 0.0
    for _ in range(4):
        m.read(1600)
    assert abs(clk.slept - 0.4) < 1e-9


def test_command_source_reads_float_pcm(tmp_path):
    p = tmp_path / "pcm.f32"
    x = np.arange(1000, dtype=np.float32)
    x.tofile(p)
    cs = audio_in.CommandSource([sys.executable, "-c",
                                 "import sys; sys.stdout.buffer.write("
                                 "open(sys.argv[1], 'rb').read())", str(p)],
                                FS)
    got = np.concatenate([cs.read(300) for _ in range(4)])
    cs.close()
    assert np.array_equal(got, x)


def test_make_source_kinds():
    assert isinstance(audio_in.make_source("silence", FS),
                      audio_in.SilenceSource)
    with pytest.raises(ValueError):
        audio_in.make_source("nope", FS)
    obj = type("S", (), {"read": lambda self, n: np.zeros(n)})()
    assert audio_in.make_source(obj, FS) is obj


class Burst:
    """An unpaced source: the array in chunks, then end of data."""

    def __init__(self, data):
        self.data = np.asarray(data, np.float32)
        self.closed = False

    def read(self, n):
        out, self.data = self.data[:n], self.data[n:]
        return out

    def close(self):
        self.closed = True


def test_capture_keeps_order_and_counts_starvation():
    data = np.arange(4800, dtype=np.float32) / 4800.0
    cap = audio_in.AudioCapture(Burst(data), 16000.0)
    cap.start()
    wait_until(lambda: cap.captured == data.size)
    blk = cap.get(1600)
    assert np.array_equal(blk, data[:1600])
    assert cap.starved == 0 and cap.measured_rate() > 0
    rest = cap.get(16000)                     # more than was captured
    assert np.array_equal(rest[:3200], data[1600:])
    assert not np.any(rest[3200:]) and cap.starved == 1
    st = cap.stats()
    assert st["captured"] == 4800 and st["fill"] == 0
    cap.stop()
    assert cap.source.closed


def test_capture_bounds_its_latency():
    cap = audio_in.AudioCapture(Burst(np.arange(48000)), FS,
                                max_latency_ms=100.0)
    cap.start()
    wait_until(lambda: cap.captured == 48000)
    cap.stop()
    assert cap.fill == 4800 and cap.dropped == 48000 - 4800
    assert cap.get(1)[0] == 48000 - 4800


# --------------------------------------------------------- the Radio plays
def _play_radios(L: int):
    """The port's and the reference's sim Radio with a player at
    48 kHz x L; the blocks each pushes to its player are kept."""
    out = []
    for cls, cfg_cls, kw in ((Radio, RadioConfig, {"device": "cpu"}),
                             (JRadio, JRadioConfig, {})):
        r = cls(cfg_cls(sample_rate=FS, mode="USB", tune_hz=10000.0,
                        playback_rate=FS * L, latency_ms=100.0),
                hardware="sim", **kw)
        r.hw.tone_hz = 11000.0
        r.enable_audio_out(sink=ListSink(), block=2048)
        pushed, push = [], r.player.push
        r.player.push = lambda a, p=pushed, f=push: (p.append(np.array(a)),
                                                     f(a))
        r.open()
        out.append((r, pushed))
    return out


@pytest.mark.parametrize("L", [1, 2, 4, 8])
def test_radio_play_equals_the_reference(L):
    (r, ours), (jr, ref) = _play_radios(L)
    try:
        for _ in range(4):
            r.run_once()
            jr.run_once()
    finally:
        r.close()
        jr.close()
    assert len(ours) == len(ref) == 4
    for k, (a, b) in enumerate(zip(ours, ref)):
        assert a.shape == b.shape == (B * L,)
        if k >= 1:
            assert snr_db(b, a) >= PLAY_DB, (L, k)
    if L > 1:
        assert r._play_interp.M.device.type == "cpu"


def test_radio_play_rate_interpolation(tmp_path):
    """After tests/test_audio_out.py:61: RX audio at 48 k interpolated x4
    to a 192 k sink; the tone's frequency kept, the images rejected."""
    cfg = RadioConfig(sample_rate=FS, mode="USB", tune_hz=10000.0,
                      playback_rate=192000.0, latency_ms=100.0)
    radio = Radio(cfg, hardware="sim", device="cpu")
    radio.hw.tone_hz = 11000.0
    p = tmp_path / "play.wav"
    radio.enable_audio_out(sink=f"wav:{p}", block=2048)
    radio.open()
    try:
        radio.run(blocks=6)
        wait_until(lambda: len(radio.player.servo.buf) == 0)
    finally:
        radio.close()
    y, fs = wav.read_audio_wav(str(p))
    assert fs == 192000.0 and len(y) >= 6 * 4 * B
    W = int(0.2 * fs)
    cs = np.concatenate([[0.0], np.cumsum(y.astype(np.float64) ** 2)])
    k0 = int(np.argmax(cs[W:] - cs[:-W]))
    seg = y[k0:k0 + W]
    X = np.abs(np.fft.rfft(seg * np.hanning(len(seg))))
    f = np.fft.rfftfreq(len(seg), 1 / fs)
    assert abs(f[np.argmax(X[10:]) + 10] - 1000.0) < 30.0
    assert 20 * np.log10(X.max() / (X[f > 40000.0].max() + 1e-12)) > 60.0


def test_enable_audio_out_refuses_a_fractional_rate():
    r = Radio(RadioConfig(sample_rate=FS, playback_rate=44100.0),
              hardware="sim", device="cpu")
    with pytest.raises(ValueError):
        r.enable_audio_out(sink=ListSink())


# ------------------------------------------------ the keyed Radio's sources
class _Zeros(Hardware):
    def __init__(self, conf=None):
        super().__init__(conf)
        self.tx = []

    def read_samples(self, n):
        return np.zeros((1, n), np.complex64)

    def write_samples(self, iq):
        self.tx.append(np.array(iq))


class _JZeros(JHardware):
    def __init__(self, conf=None):
        super().__init__(conf)
        self.tx = []

    def read_samples(self, n):
        return np.zeros((1, n), np.complex64)

    def write_samples(self, iq):
        self.tx.append(np.array(iq))


def _tx_pair(mode="USB", tune=7000.0, warm=False):
    """The port's and the reference's Radio with a TX chain on hardware
    that keeps what is transmitted.  ``warm``: one RX block and one TX
    block of silence first (the reference compiles its steps there), the
    TX block not kept."""
    r = Radio(RadioConfig(sample_rate=FS, mode=mode, tune_hz=tune,
                          agc=False), hardware=_Zeros(), device="cpu")
    jr = JRadio(JRadioConfig(sample_rate=FS, mode=mode, tune_hz=tune,
                             agc=False), hardware=_JZeros())
    for x in (r, jr):
        x.open()
        x.enable_tx()
        if warm:
            x.run_once()
            x.transmit(np.zeros(x.tx.block, np.float32), ptt=True)
            x.hw.tx.clear()
    return r, jr


def test_live_mic_session_equals_the_reference():
    """A PTT SSB session from a paced file mic (enable_mic): both radios
    wait until their capture holds the session's mic, key the same blocks
    and transmit the same IQ (>= 80 dB); no starvation."""
    tone = (0.3 * np.sin(2.0 * np.pi * 1000.0 * np.arange(24000) / FS)
            ).astype(np.float32)
    r, jr = _tx_pair(warm=True)
    try:
        # the capture holds a minute: the session's blocks stay in it
        # however slowly a loaded CPU runs them
        for x in (r, jr):
            x.enable_mic(tone, latency_ms=60000.0)
        need = 6 * B
        wait_until(lambda: r.mic.fill >= need and jr.mic.fill >= need)
        keyed = []
        for i in range(6):
            for x in (r, jr):
                x.set_ptt(2 <= i < 5)
                x.run_once()
            keyed.append((r._keyed, jr._keyed))
        assert all(a == b for a, b in keyed), keyed
        assert [a for a, _ in keyed][2:5] == [True] * 3, keyed
        assert len(r.hw.tx) == len(jr.hw.tx) >= 3
        for a, b in zip(r.hw.tx, jr.hw.tx):
            assert snr_db(b, a) >= TX_DB
        iq = np.concatenate(r.hw.tx)
        S = np.abs(np.fft.fft(iq * np.hanning(len(iq))))
        f = np.fft.fftfreq(len(iq), 1.0 / FS)
        assert abs(f[np.argmax(S)] - 1000.0) < 50.0
        assert r.mic.stats()["starved"] == 0
        assert r.mic.stats()["dropped"] == 0
    finally:
        r.close()
        jr.close()
    assert r.mic is None                         # close stopped the capture


def test_vox_keys_the_loop_from_the_capture():
    """VOX keys from a live capture's level and releases after the hold,
    as the reference's does, with the same TX IQ (>= 80 dB)."""
    loud = (0.3 * np.sin(2.0 * np.pi * 700.0 * np.arange(2 * B) / FS)
            ).astype(np.float32)
    r, jr = _tx_pair()
    try:
        for x in (r, jr):
            x.set_vox(True, threshold=0.05, hold_secs=0.05)
            x.enable_mic(Burst(loud))
        wait_until(lambda: r.mic.captured == loud.size
                   and jr.mic.captured == loud.size)
        keyed = []
        for _ in range(5):
            r.run_once()
            jr.run_once()
            keyed.append((r.ptt.transmitting, jr.ptt.transmitting))
        assert all(a == b for a, b in keyed), keyed
        assert any(a for a, _ in keyed[:2]) and not keyed[-1][0], keyed
        assert len(r.hw.tx) == len(jr.hw.tx) > 0
        for a, b in zip(r.hw.tx, jr.hw.tx):
            assert snr_db(b, a) >= TX_DB
    finally:
        r.close()
        jr.close()


@pytest.mark.parametrize("rate", [FS, 44100.0])
def test_cq_keyer_equals_the_reference(tmp_path, rate):
    """file_play_source 12 (quisk.py:5926): the CQ WAV keys the radio for
    its length, the radio listens for repeat_secs, the message repeats,
    stop_cq ends it; a 44.1 kHz message goes through VarRateResampler.
    The keyed pattern and the TX IQ equal the reference Radio's."""
    n = int(2 * B * rate / FS)
    msg = (0.3 * np.sin(2 * np.pi * 800.0 * np.arange(n) / rate)
           ).astype(np.float32)
    p = tmp_path / "cq.wav"
    wav.write_audio_wav(str(p), msg, rate)
    r, jr = _tx_pair()
    states = []
    for x in (r, jr):
        x.play_cq(str(p), repeat_secs=B / FS)
    for _ in range(5):
        r.run_once()
        jr.run_once()
        states.append((r._keyed, jr._keyed))
    assert [a for a, _ in states] == [b for _, b in states]
    assert states[0][0] and states[1][0]
    assert not all(a for a, _ in states[2:4]) and any(a for a, _ in states[3:])
    for x in (r, jr):
        x.stop_cq()
        x.run_once()
    assert not r._keyed and r._cq is None
    assert len(r.hw.tx) == len(jr.hw.tx) >= 3
    for a, b in zip(r.hw.tx, jr.hw.tx):
        assert snr_db(b, a) >= TX_DB


def test_cq_one_shot_unkeys_by_itself(tmp_path):
    p = tmp_path / "cq.wav"
    wav.write_audio_wav(str(p), 0.3 * np.ones(B // 2, np.float32), FS)
    r = Radio(RadioConfig(sample_rate=FS, tune_hz=7000.0, agc=False),
              hardware=_Zeros(), device="cpu")
    with pytest.raises(ValueError):
        r.play_cq(str(p))                    # no TX chain yet
    r.enable_tx()
    r.play_cq(str(p))
    r.run_once()
    assert r._keyed and r._cq is None
    r.run_once()
    assert not r._keyed and len(r.hw.tx) == 1


def test_serial_key_keys_the_loop_and_transmit():
    """enable_serial_key with injected modem bits: CTS as PTT keys the
    block loop; DSR as the CW key reaches transmit()."""
    bits = {"cts": 0, "dsr": 0}
    r = Radio(RadioConfig(sample_rate=FS, tune_hz=7000.0, agc=False,
                          mode="CWU"), hardware=_Zeros(), device="cpu")
    r.enable_tx()
    assert r.enable_serial_key(cts="PTT", dsr="CW when high",
                               read_bits=lambda: (bits["cts"],
                                                  bits["dsr"])) == ""
    r.run_once()
    assert not r._keyed
    bits["cts"] = 1
    r.run_once()
    assert r._keyed and r.serial_key.ptt
    bits["cts"] = 0
    r.run_once()
    assert not r.serial_key.ptt
    bits["dsr"] = 1
    iq = r.transmit(np.zeros(r.tx.block, np.float32))
    assert iq is not None and r.serial_key.key_down
    assert r.enable_serial_key(port="/nonexistent/tty", cts="PTT") != ""
    r.close()
    assert getattr(r, "serial_key", None) is None
