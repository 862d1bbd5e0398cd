"""The port's five example programs (examples/torch_*.py) on the CPU,
each against its JAX original (examples/*.py) on the same arguments.

The JAX originals run in subprocesses, all started together when a test
first asks for one, as tests/test_demo_channelizer.py runs its demos; the
port's programs run in this process through their ``run`` functions, with
torch on one thread (tests/test_torch_rx.py: a worker thread's cos has
been off by ~1e-4 on some CPU hosts).  Floors, each a row's SNR of the
port's output against the original's:

- receiver (``--seconds 0.3``, 7 blocks): the WAVs read back, the SSB, AM
  and CW rows >= FEATURED_DB from block FROM_BLOCK on (the first three
  blocks are the featured chain's start-up residue), the NFM row by RMS
  within FM_RMS_DB; the printed station list equal;
- channelizer (K=256, the port on the plain versions of kernels #4 and
  #6): the WAV >= WAV_DB, the strongest-channel lines equal;
- transceiver: ``loopback`` (SSB and FM with CTCSS) >= TX_DB, FM from
  block FM_FROM_BLOCK on (below), the IMD before and after PureSignal
  within IMD_DB; a 1 kHz tone through the SSB loopback; the program's paced
  ``live_session`` with tests/test_tx_runtime.py's assertions;
- wideband survey (64 channels, 4 blocks): no sequence error, the WAV
  >= WAV_DB, the same three strongest channels;
- station automation: tests/test_station_example.py's three fan-out
  checks on the port's ``Radio``.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from scipy.signal import firwin, hilbert

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples")
sys.path.insert(0, EXAMPLES)

import torch_demo_channelizer as tch  # noqa: E402
import torch_demo_receiver as trx  # noqa: E402
import torch_demo_transceiver as ttx  # noqa: E402
import torch_demo_wideband_survey as tsv  # noqa: E402
import torch_station_automation as tsa  # noqa: E402

from quisk_tpu_torch.app.config import RadioConfig  # noqa: E402
from quisk_tpu_torch.app.radio import Radio  # noqa: E402
from quisk_tpu_torch.io import wav  # noqa: E402
from quisk_tpu_torch.io.audio_in import AudioCapture  # noqa: E402

PROGRAMS = {"torch_demo_receiver.py": trx, "torch_demo_channelizer.py": tch,
            "torch_demo_transceiver.py": ttx,
            "torch_demo_wideband_survey.py": tsv,
            "torch_station_automation.py": tsa}
FEATURED_DB = 60.0       # tests/test_torch_rx.py:440
FROM_BLOCK = 3
FM_RMS_DB = 0.5
WAV_DB = 60.0
TX_DB = 80.0             # tests/test_torch_tx.py
IMD_DB = 0.1
# The FM loopback's first block holds the signal's onset at the RX FM
# discriminator: its first outputs are ~1e-6, and whether
# |x[n] conj(x[n-1])| clears the 1e-12 gate (ops/demod.py:103) there turns
# on the channel filter's rounding.  On the same TX IQ the two packages'
# RX chains open the gate 4 samples apart (audio 1746 against 1750);
# de-emphasis and AGC carry it through block 0 (60.1 dB), block 1 is
# 109.5 dB and blocks 2-9 >= 130 dB.  SSB has no such gate: from block 0.
FM_FROM_BLOCK = 1
RHO = 0.7                # tests/test_tx_runtime.py:157
SMETER_DB = -40.0
B = 2048
RX_SECONDS = 0.3
SURVEY_ARGS = ("--channels", "64", "--blocks", "4")
RUN_TIMEOUT_S = 600

# the JAX transceiver's functions, run in a process of their own
TX_REF = """
import sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, {examples!r})
import demo_transceiver as d
part, out = sys.argv[1], sys.argv[2]
if part == "loopback":
    np.savez(out, ssb=d.loopback("USB", "USB")[1],
             fm=d.loopback("FM", "FM", ctcss_hz=88.5)[1])
else:
    np.savez(out, imd=np.asarray(d.imd_demo()))
"""


@pytest.fixture(autouse=True, scope="module")
def _torch_one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class JaxRuns:
    """The JAX originals, each in a process of its own with its own output
    directory; all start at the first ``result`` call, which then waits for
    the one asked for and returns (stdout, output directory)."""

    def __init__(self, tmp):
        self.tmp, self.procs, self.done = tmp, {}, {}

    def commands(self) -> dict:
        code = TX_REF.format(examples=EXAMPLES)
        return {
            "receiver": ["demo_receiver.py", "--seconds", str(RX_SECONDS)],
            "channelizer": ["demo_channelizer.py"],
            "survey": ["demo_wideband_survey.py", *SURVEY_ARGS],
            "loopback": ["-c", code, "loopback"],
            "imd": ["-c", code, "imd"],
        }

    def start(self) -> None:
        for name, argv in self.commands().items():
            d = self.tmp / name
            d.mkdir()
            if argv[0] == "-c":
                argv = [*argv, str(d / "out.npz")]
            else:
                argv = [os.path.join(EXAMPLES, argv[0]), *argv[1:],
                        "--out-dir", str(d)]
            log = open(d / "log.txt", "w")
            self.procs[name] = (subprocess.Popen(
                [sys.executable, *argv], cwd=REPO, stdout=log,
                stderr=subprocess.STDOUT, text=True), log)

    def result(self, name: str) -> tuple[str, object]:
        if not self.procs:
            self.start()
        if name not in self.done:
            p, log = self.procs[name]
            try:
                p.wait(timeout=RUN_TIMEOUT_S)
            finally:
                log.close()
            out = (self.tmp / name / "log.txt").read_text()
            assert p.returncode == 0, out
            self.done[name] = (out, self.tmp / name)
        return self.done[name]

    def kill(self) -> None:
        for p, log in self.procs.values():
            p.kill()
            p.wait()
            log.close()


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    runs = JaxRuns(tmp_path_factory.mktemp("jax_examples"))
    yield runs
    runs.kill()


def snr_db(ref, got) -> float:
    ref = np.asarray(ref, np.float64)
    err = np.mean((np.asarray(got, np.float64) - ref) ** 2)
    return float(10 * np.log10(np.mean(ref ** 2) / max(err, 1e-30)))


def rms_db(ref, got) -> float:
    return float(20 * np.log10(np.sqrt(np.mean(np.square(got)))
                               / np.sqrt(np.mean(np.square(ref)))))


def read_wav(path) -> np.ndarray:
    return wav.read_audio_wav(str(path))[0]


def lines_between(out: str, first: str, stop: str) -> list[str]:
    lines = out.splitlines()
    i = next(k for k, s in enumerate(lines) if s.startswith(first))
    j = next(k for k in range(i + 1, len(lines))
             if lines[k].startswith(stop))
    return lines[i:j]


# ------------------------------------------------------------- receiver
def test_receiver_against_the_jax_demo(jax_runs, tmp_path, capsys):
    res = trx.run("cpu", RX_SECONDS, str(tmp_path))
    out = capsys.readouterr().out
    jout, jdir = jax_runs.result("receiver")
    assert res["blocks"] == 7 and res["audio"].shape == (4, 7 * B)
    assert (lines_between(out, "band:", "spectrum")
            == lines_between(jout, "band:", "spectrum"))
    tail = slice(FROM_BLOCK * B, None)
    for name, _, mode in res["stations"]:
        got = read_wav(tmp_path / trx.wav_name(name))[tail]
        ref = read_wav(jdir / trx.wav_name(name))[tail]
        if mode == "FM":
            assert abs(rms_db(ref, got)) < FM_RMS_DB, name
        else:
            assert snr_db(ref, got) >= FEATURED_DB, name


# ---------------------------------------------------------- channelizer
def test_channelizer_against_the_jax_demo(jax_runs, tmp_path, capsys):
    res = tch.run("cpu", 256, str(tmp_path))
    out = capsys.readouterr().out
    jout, jdir = jax_runs.result("channelizer")
    assert res["pipe"].pallas_demod and res["pipe"].pfb.pallas_poly
    assert "fused stage-2 IDFT + demod kernel" in out
    assert (lines_between(out, "256-channel PFB", "wrote")
            == lines_between(jout, "256-channel PFB", "wrote"))
    got = read_wav(tmp_path / "pfb_ch5_am.wav")
    ref = read_wav(jdir / "pfb_ch5_am.wav")
    assert got.shape == ref.shape == (8 * 1024 * 2,)
    assert snr_db(ref, got) >= WAV_DB


def test_channelizer_off_the_kernel_width(tmp_path):
    """At K=128 (K/128 odd) the demod stays on the torch-op route, whose
    audio is in channel order: the three stations are on top."""
    res = tch.run("cpu", 128, str(tmp_path))
    assert not res["pipe"].pallas_demod and res["pipe"].pfb.pallas_poly
    assert res["audio"].shape == (128, 8 * 1024 * 2)
    top = set(np.argsort(res["power"])[::-1][:3].tolist())
    assert top == {5, 128 - 9, 17}


# ---------------------------------------------------------- transceiver
@pytest.mark.parametrize("name,mode,ctcss", [("ssb", "USB", 0.0),
                                             ("fm", "FM", 88.5)])
def test_loopback_against_the_jax_demo(jax_runs, name, mode, ctcss):
    voice, audio = ttx.loopback(mode, mode, ctcss_hz=ctcss, device="cpu")
    _, jdir = jax_runs.result("loopback")
    ref = np.load(jdir / "out.npz")[name]
    assert audio.shape == ref.shape == (10 * B,)
    skip = FM_FROM_BLOCK * B if mode == "FM" else 0
    assert snr_db(ref[skip:], audio[skip:]) >= TX_DB, name


def test_imd_demo_against_the_jax_demo(jax_runs):
    before, after = ttx.imd_demo("cpu")
    _, jdir = jax_runs.result("imd")
    jb, ja = np.load(jdir / "out.npz")["imd"]
    assert abs(before - jb) < IMD_DB and abs(after - ja) < IMD_DB
    assert after < before - 20.0


def test_loopback_beat_of_a_tone():
    """A 1 kHz mic tone through the SSB loopback comes back at 1 kHz."""
    tone = 0.3 * np.sin(2 * np.pi * 1000.0 * np.arange(6 * B) / 48000.0)
    _, audio = ttx.loopback("USB", "USB", blocks=6, device="cpu",
                            voice=tone)
    seg = audio[3 * B:]
    S = np.abs(np.fft.rfft(seg * np.hanning(len(seg))))
    f = np.fft.rfftfreq(len(seg), 1.0 / 48000.0)
    assert abs(f[np.argmax(S)] - 1000.0) < 30.0


def test_live_session_recovers_voice(monkeypatch):
    """The program's paced live session with tests/test_tx_runtime.py's
    assertions: the own signal on the S-meter, the voice recovered.  The
    voice is held to the mic blocks the keyed loop took: on the CPU a
    keyed block takes ~0.3 s, longer than the 43 ms the capture clock
    fills it in, so the capture runs ahead, wraps the voice and drops its
    oldest samples past its 2 s latency."""
    taken = []
    get = AudioCapture.get

    def recording_get(self, n):
        taken.append(get(self, n))
        return taken[-1]

    monkeypatch.setattr(AudioCapture, "get", recording_get)
    blocks = 16
    _, audio, smeter = ttx.live_session(blocks=blocks, device="cpu")
    assert smeter > SMETER_DB, smeter
    assert len(taken) == blocks + 1          # the keyed blocks, then key-up
    mic = np.concatenate(taken[:blocks])
    seg = slice(6 * B, 14 * B)
    core = firwin(257, [500.0, 2200.0], fs=48000.0, pass_zero=False)
    v = np.convolve(mic[seg], core, "same")
    a = np.convolve(audio[seg], core, "same")
    av, aa = hilbert(v), hilbert(a)
    c = np.array([np.abs(np.vdot(av[:-4000], aa[lag:lag + len(av) - 4000]))
                  for lag in range(4000)])
    best = int(np.argmax(c))
    a2 = aa[best:best + len(av) - 4000]
    v2 = av[:len(a2)]
    rho = float(np.abs(np.vdot(v2, a2))
                / (np.linalg.norm(v2) * np.linalg.norm(a2)))
    assert rho > RHO, (rho, best)
    assert float(np.std(np.real(a2))) > 5.0 * max(float(np.std(audio[:B])),
                                                  1e-6)


# ------------------------------------------------------- wideband survey
def test_survey_against_the_jax_demo(jax_runs, tmp_path, capsys):
    res = tsv.run("cpu", 64, 4, str(tmp_path))
    out = capsys.readouterr().out
    jout, jdir = jax_runs.result("survey")
    assert "0 seq errors" in out and "0 seq errors" in jout
    assert res["stats"]["seq_errors"] == 0 and res["blocks"] == 4
    assert res["pipe"].pfb.pallas_poly and not res["pipe"].pallas_demod
    assert (lines_between(out, "  ch ", "wrote")
            == lines_between(jout, "  ch ", "wrote"))
    got = read_wav(tmp_path / "survey_am.wav")
    ref = read_wav(jdir / "survey_am.wav")
    assert got.shape == ref.shape
    assert snr_db(ref, got) >= WAV_DB


# ---------------------------------------------------- station automation
def _radio():
    cfg = RadioConfig(sample_rate=48000.0, mode="USB", audio_block=2048)
    hw = tsa.StationHardware(cfg)
    return Radio(cfg, hardware=hw, device="cpu"), hw


def test_tuner_follows_qsy():
    radio, hw = _radio()
    hw.open()
    radio.set_frequency(7_074_000)
    assert hw.anttuner.tune_count == 1
    radio.set_frequency(7_076_000)          # within the matched window
    assert hw.anttuner.tune_count == 1
    radio.set_frequency(7_200_000)          # out of window -> re-tune
    assert hw.anttuner.tune_count == 2
    assert hw.tx_frequency == 7_200_000     # base plugin still updated
    radio.close()


def test_band_change_switches_filter_and_resets_tuner():
    radio, hw = _radio()
    radio.set_band("20")
    assert hw.filterbox.relay == hw.filterbox.BANDS["20"]
    assert hw.anttuner.tuned_hz is not None   # set_band tunes the center
    before = hw.anttuner.tune_count
    radio.set_band("40")
    radio.set_frequency(7_074_000)
    assert hw.anttuner.tune_count > before    # band change forced a re-tune
    radio.close()


def test_ptt_interlock_and_heartbeat_and_samples():
    radio, hw = _radio()
    hw.open()
    hw.OnButtonPTT(True)
    assert hw.controlbox.tx_enabled
    hw.OnButtonPTT(False)
    assert not hw.controlbox.tx_enabled
    hw.HeartBeat()
    hw.HeartBeat()
    assert hw.controlbox.heartbeat_count == 2
    audio = radio.run_once()                 # sample plane delegates to sim
    assert audio is not None and np.all(np.isfinite(audio))
    radio.close()


def test_station_session_and_the_registry():
    from quisk_tpu_torch.hw import get_hardware
    hw, audio = tsa.run("cpu")
    assert get_hardware("station_demo") is tsa.StationHardware
    assert hw.anttuner.tune_count == 4 and hw.filterbox.relay == 5
    assert hw.controlbox.heartbeat_count == 1
    assert not hw.controlbox.tx_enabled
    assert audio.shape == (1, B) and np.all(np.isfinite(audio))


# ---------------------------------------------------------- every program
@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_program_without_a_card_raises(monkeypatch, tmp_path, name):
    """No card and no --cpu: the program raises before it does any work;
    it never carries on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [] if name == "torch_station_automation.py" else [
        "--out-dir", str(tmp_path)]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PROGRAMS[name].main(argv)
    assert not list(tmp_path.iterdir())


def test_programs_load_no_jax():
    names = ", ".join(m[:-3] for m in sorted(PROGRAMS))
    code = (f"import sys\nsys.path.insert(0, {EXAMPLES!r})\n"
            f"import {names}\n"
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'flax', 'quisk_tpu.')) "
            "or m == 'quisk_tpu']\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=REPO)
    assert r.returncode == 0, r.stderr
