"""Capture-side audio: microphone sources + a capture thread.

Parity: the reference's capture side — the sound loop reads the
microphone device every iteration (sound.c:1034-1094) and measures the
achieved mic sample rate against the nominal one (microphone.c:1105-1122,
``quisk_sound_state.mic_read_rate``).  The ~5200 LoC of per-OS capture
drivers (sound_alsa.c / sound_pulseaudio.c / ...) collapse, like the
playback side in :mod:`quisk_tpu_torch.io.audio_out`, to a ``Source`` protocol:
``read(n)`` returns up to ``n`` float32 samples, blocking at the source's
real-time rate.

Sources provided (mirroring the sink set):
- :class:`SilenceSource` — real-time-paced zeros (the portable default),
- :class:`ClockedFileMic` — a float32 array or WAV file replayed at the
  mic clock (optionally looped) — the test/demo microphone,
- :class:`CommandSource` — read PCM from an external capture command
  (e.g. ``arecord -f FLOAT_LE -r 48000``) when one exists on the host.

:class:`AudioCapture` owns the reader thread: it pulls from the source at
the source's clock into a bounded buffer; the radio block loop calls
:meth:`AudioCapture.get` non-blocking each iteration (zero-filling and
counting a starvation when the mic is behind, like the reference's
read-error counters in quisk_sound_state).
"""

from __future__ import annotations

import subprocess
import threading
import time

import numpy as np


class SilenceSource:
    """Paced zeros — a microphone with nothing plugged in."""

    def __init__(self, rate: float):
        self.rate = float(rate)
        self._t0 = None
        self._read = 0

    def read(self, n: int) -> np.ndarray:
        now = time.perf_counter()
        if self._t0 is None:
            self._t0 = now
        self._read += n
        dt = self._t0 + self._read / self.rate - time.perf_counter()
        if dt > 0:
            time.sleep(dt)
        return np.zeros(n, np.float32)

    def close(self) -> None:
        pass


class ClockedFileMic:
    """Replay a float32 array (or mono WAV file) at the mic clock.

    ``loop=True`` wraps around forever; otherwise read() returns an empty
    array at end-of-data (the capture thread then stops).
    """

    def __init__(self, data, rate: float, loop: bool = True):
        if isinstance(data, str):
            from quisk_tpu_torch.io.wav import read_audio_wav
            audio, file_rate = read_audio_wav(data)
            data = np.asarray(audio, np.float32)
            if data.ndim > 1:
                data = data.mean(axis=0)
            rate = float(rate or file_rate)
        self.data = np.asarray(data, np.float32).ravel()
        self.rate = float(rate)
        self.loop = loop
        self.pos = 0
        self._t0 = None
        self._read = 0

    def read(self, n: int) -> np.ndarray:
        now = time.perf_counter()
        if self._t0 is None:
            self._t0 = now
        out = np.empty(n, np.float32)
        got = 0
        while got < n:
            take = min(n - got, len(self.data) - self.pos)
            if take <= 0:
                if not self.loop:
                    out = out[:got]
                    break
                self.pos = 0
                continue
            out[got:got + take] = self.data[self.pos:self.pos + take]
            self.pos += take
            got += take
        self._read += len(out)
        dt = self._t0 + self._read / self.rate - time.perf_counter()
        if dt > 0:
            time.sleep(dt)
        return out

    def close(self) -> None:
        pass


class CommandSource:
    """Read float32 PCM from an external capture command's stdout
    (``arecord``/``parec``/``sox``) — the host's real microphone."""

    def __init__(self, argv: list[str], rate: float):
        self.rate = float(rate)
        self.proc = subprocess.Popen(argv, stdout=subprocess.PIPE)

    def read(self, n: int) -> np.ndarray:
        data = self.proc.stdout.read(4 * n)
        if not data:
            return np.zeros(0, np.float32)
        return np.frombuffer(data, np.float32)

    def close(self) -> None:
        try:
            self.proc.stdout.close()
            self.proc.terminate()
            self.proc.wait(timeout=2)
        except Exception:
            self.proc.kill()


def make_source(kind, rate: float):
    """'silence' | 'wav:<path>' | 'arecord' | array-like -> a Source."""
    if isinstance(kind, str):
        if kind == "silence":
            return SilenceSource(rate)
        if kind.startswith("wav:"):
            return ClockedFileMic(kind.split(":", 1)[1], rate)
        if kind == "arecord":
            return CommandSource(["arecord", "-q", "-f", "FLOAT_LE", "-c",
                                  "1", "-r", str(int(rate))], rate)
        raise ValueError(f"unknown mic source {kind!r}")
    if hasattr(kind, "read"):
        return kind
    return ClockedFileMic(np.asarray(kind, np.float32), rate)


class AudioCapture:
    """Mic reader thread + bounded buffer + achieved-rate measurement.

    The thread pulls ``chunk`` samples at a time from the source (which
    paces itself); the block loop calls :meth:`get` non-blocking.  The
    measured rate (parity microphone.c:1105-1122) is samples captured
    over wall time since the first read, available via :meth:`stats`.
    """

    def __init__(self, source, rate: float, max_latency_ms: float = 500.0,
                 chunk: int = 512):
        self.source = source
        self.rate = float(rate)
        self.chunk = int(chunk)
        self.max_samples = int(rate * max_latency_ms / 1000.0)
        self._buf = np.zeros(0, np.float32)
        self._lock = threading.Lock()
        self._run = False
        self._thread = None
        self._t0 = None
        self.captured = 0
        self.starved = 0
        self.dropped = 0

    def start(self) -> None:
        self._run = True
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="quisk-audio-in")
        self._thread.start()

    def _loop(self) -> None:
        while self._run:
            blk = self.source.read(self.chunk)
            if self._t0 is None:
                self._t0 = time.perf_counter()
            if blk is None or len(blk) == 0:
                break                      # end of a non-looping source
            with self._lock:
                self._buf = np.concatenate([self._buf, blk])
                self.captured += len(blk)
                if len(self._buf) > self.max_samples:
                    # mic far ahead of the consumer: drop the oldest
                    # (bounded latency, like the reference's ring)
                    self.dropped += len(self._buf) - self.max_samples
                    self._buf = self._buf[-self.max_samples:]

    def get(self, n: int) -> np.ndarray:
        """Exactly ``n`` mic samples, zero-padded (and counted starved)
        when the capture is behind — never blocks the block loop."""
        with self._lock:
            take = min(n, len(self._buf))
            out = self._buf[:take]
            self._buf = self._buf[take:]
        if take < n:
            self.starved += 1
            out = np.concatenate([out, np.zeros(n - take, np.float32)])
        return out

    @property
    def fill(self) -> int:
        with self._lock:
            return len(self._buf)

    def measured_rate(self) -> float:
        """Achieved capture rate, Hz (microphone.c:1105 mic_read_rate)."""
        if self._t0 is None or self.captured == 0:
            return 0.0
        dt = time.perf_counter() - self._t0
        return self.captured / dt if dt > 0 else 0.0

    def stats(self) -> dict:
        return {"captured": self.captured, "starved": self.starved,
                "dropped": self.dropped, "fill": self.fill,
                "measured_rate": self.measured_rate()}

    def stop(self) -> None:
        self._run = False
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        self.source.close()
