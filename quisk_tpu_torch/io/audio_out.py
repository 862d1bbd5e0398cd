"""Paced audio playback: sinks + a player thread driven by the fill servo.

Parity: the reference's playback side — ``play_sound_interface``
(sound.c:504-618) pulls blocks at the device's clock, the fill servo
inserts/drops interpolated samples to null capture/playback clock skew
(sound.c:534-549), and the RX path interpolates x2/4/8 from the 48 k
internal rate to the playback rate (quisk.c:2663-2682).  Device drivers
(sound_alsa.c and friends, ~5200 LoC of per-OS code) collapse here to a
``Sink`` protocol: ``write(block)`` blocks at the sink's real-time rate.

Sinks provided:
- :class:`ClockedNullSink` — a real-time-paced bit-bucket (the portable
  default; also what tests use to prove pacing),
- :class:`WavFileSink` — capture to a WAV file,
- :class:`CommandSink` — pipe PCM to an external player command (e.g.
  ``aplay -f FLOAT_LE -r 48000``) when one exists on the host.
"""

from __future__ import annotations

import subprocess
import threading
import time

import numpy as np

from quisk_tpu_torch.io.ratematch import RateServo


class ClockedNullSink:
    """Discards audio but blocks write() at the real-time rate — the
    pacing element the fill servo needs when no sound device exists."""

    def __init__(self, rate: float, channels: int = 1):
        self.rate = float(rate)
        self.channels = channels
        self._t0 = None
        self._written = 0

    def write(self, block: np.ndarray) -> None:
        n = block.shape[-1]
        now = time.perf_counter()
        if self._t0 is None:
            self._t0 = now
        self._written += n
        target = self._t0 + self._written / self.rate
        dt = target - time.perf_counter()
        if dt > 0:
            time.sleep(dt)

    def close(self) -> None:
        pass


class WavFileSink:
    def __init__(self, path, rate: float, channels: int = 1):
        self.path = path
        self.rate = rate
        self._chunks: list[np.ndarray] = []

    def write(self, block: np.ndarray) -> None:
        self._chunks.append(np.asarray(block, np.float32).copy())

    def close(self) -> None:
        from quisk_tpu_torch.io.wav import write_audio_wav
        audio = (np.concatenate(self._chunks)
                 if self._chunks else np.zeros(0, np.float32))
        write_audio_wav(self.path, audio, self.rate)


class CommandSink:
    """Pipe float32 PCM into an external player (aplay/pacat/sox)."""

    def __init__(self, argv: list[str], rate: float, channels: int = 1):
        self.proc = subprocess.Popen(argv, stdin=subprocess.PIPE)

    def write(self, block: np.ndarray) -> None:
        data = np.ascontiguousarray(
            np.atleast_2d(block).T, np.float32).tobytes()
        self.proc.stdin.write(data)

    def close(self) -> None:
        try:
            self.proc.stdin.close()
            self.proc.wait(timeout=2)
        except Exception:
            self.proc.kill()


class AudioPlayer:
    """Producer/consumer playback with the reference's fill servo.

    The RX loop calls :meth:`push` with audio blocks at the capture
    clock; a player thread pulls fixed blocks at the sink's clock.  The
    RateServo between them resamples by ppm-level amounts to hold the
    buffer at 50% fill, healing the skew between the two clocks
    (sound.c:534-618).
    """

    def __init__(self, sink, rate: float, latency_ms: float = 150.0,
                 block: int = 1024):
        self.sink = sink
        self.rate = float(rate)
        self.block = block
        buffer_samples = int(2 * rate * latency_ms / 1000.0)
        self.servo = RateServo(buffer_samples, dtype=np.float32)
        self._lock = threading.Lock()
        self._run = False
        self._thread = None
        self.blocks_played = 0

    # -- producer side (RX loop) ------------------------------------------
    def push(self, audio: np.ndarray) -> None:
        with self._lock:
            self.servo.feed(np.asarray(audio, np.float32))

    @property
    def fill(self) -> float:
        with self._lock:
            return self.servo.fill

    # -- consumer side -----------------------------------------------------
    def start(self) -> None:
        self._run = True
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="quisk-audio-out")
        self._thread.start()

    def _loop(self) -> None:
        # half-fill prime before the clock starts (ref: latency preload)
        t0 = time.time()
        while self._run and self.fill < 0.25 and time.time() - t0 < 2.0:
            time.sleep(0.005)
        while self._run:
            with self._lock:
                empty = len(self.servo.buf) == 0
                blk = None if empty else self.servo.read(self.block)
            if blk is None:
                # starved: pace one block period ourselves instead of
                # spinning zero-writes into a non-blocking sink
                time.sleep(self.block / self.rate)
                continue
            self.sink.write(blk)
            self.blocks_played += 1

    def stop(self) -> None:
        self._run = False
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        self.sink.close()

    def stats(self) -> dict:
        return {"fill": self.fill, "underruns": self.servo.underruns,
                "overruns": self.servo.overruns,
                "blocks_played": self.blocks_played}


def make_sink(kind: str, rate: float, path=None):
    """'null' | 'wav:<path>' | 'aplay' -> a Sink."""
    if kind == "null":
        return ClockedNullSink(rate)
    if kind.startswith("wav"):
        return WavFileSink(path or kind.split(":", 1)[1], rate)
    if kind == "aplay":
        return CommandSink(["aplay", "-q", "-f", "FLOAT_LE", "-c", "1",
                            "-r", str(int(rate))], rate)
    raise ValueError(f"unknown sink {kind!r}")
