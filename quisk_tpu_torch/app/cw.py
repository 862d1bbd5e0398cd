"""CW keying: click-free envelopes, sidetone, morse timing, jitter buffer.

Parity targets in the reference:
- key-down/up raised-cosine envelope, 5 ms rise/fall, so keying never
  clicks (quisk.c:2371-2433, envelope at 2386/2408)
- sidetone generation at the CW pitch (sound.c:679 quisk_make_sidetone)
- serial/remote CW key events carried as timestamped samples
  (microphone.c:1540 serial_key_samples) with a ~20 ms jitter buffer for
  remote operation (ac2yd/remote_common.py:78-82)
- morse timing (dit = 1.2/wpm seconds, standard PARIS weighting)
"""

from __future__ import annotations

import numpy as np

MORSE = {
    "a": ".-", "b": "-...", "c": "-.-.", "d": "-..", "e": ".", "f": "..-.",
    "g": "--.", "h": "....", "i": "..", "j": ".---", "k": "-.-", "l": ".-..",
    "m": "--", "n": "-.", "o": "---", "p": ".--.", "q": "--.-", "r": ".-.",
    "s": "...", "t": "-", "u": "..-", "v": "...-", "w": ".--", "x": "-..-",
    "y": "-.--", "z": "--..", "0": "-----", "1": ".----", "2": "..---",
    "3": "...--", "4": "....-", "5": ".....", "6": "-....", "7": "--...",
    "8": "---..", "9": "----.", "/": "-..-.", "?": "..--..", ",": "--..--",
    ".": ".-.-.-", "=": "-...-", "+": ".-.-.",
}


def text_to_key_samples(text: str, wpm: float, fs: float) -> np.ndarray:
    """Morse key waveform (0/1 float32) for `text` at `wpm` words/minute.

    Standard timing: dit=1 unit, dah=3, intra-element gap=1, inter-letter
    gap=3, inter-word gap=7; unit = 1.2/wpm seconds.
    """
    unit = int(round(1.2 / wpm * fs))
    out = []
    for word in text.lower().split():
        for li, letter in enumerate(word):
            code = MORSE.get(letter)
            if code is None:
                continue
            if li:
                out.append(np.zeros(3 * unit, np.float32))
            for ei, el in enumerate(code):
                if ei:
                    out.append(np.zeros(unit, np.float32))
                out.append(np.ones((3 if el == "-" else 1) * unit, np.float32))
        out.append(np.zeros(7 * unit, np.float32))
    if not out:
        return np.zeros(0, np.float32)
    return np.concatenate(out)


class KeyEnvelope:
    """Streaming raised-cosine keying envelope (parity quisk.c:2386).

    feed a 0/1 key waveform block; returns the smoothed envelope with
    ``rise_ms`` half-cosine edges and exact streaming continuity.
    """

    def __init__(self, fs: float, rise_ms: float = 5.0):
        self.n_edge = max(1, int(rise_ms * 1e-3 * fs))
        # half-cosine 0 -> 1
        self.ramp = 0.5 - 0.5 * np.cos(
            np.pi * (np.arange(self.n_edge) + 1) / self.n_edge)
        self.level = 0.0            # current envelope value
        self.pos = 0                # position on the ramp (signed by dir)

    def process(self, key: np.ndarray) -> np.ndarray:
        key = np.asarray(key)
        out = np.empty(len(key), np.float32)
        level = self.level
        step = 1.0 / self.n_edge
        # envelope slews toward the key state with limited rate, shaped by
        # cosine: integrate the ramp in the slew domain
        ramp_pos = np.arcsin(np.sqrt(np.clip(level, 0.0, 1.0))) * 2 / np.pi
        for i, k in enumerate(key):
            ramp_pos = min(1.0, ramp_pos + step) if k > 0.5 else \
                max(0.0, ramp_pos - step)
            level = 0.5 - 0.5 * np.cos(np.pi * ramp_pos)
            out[i] = level
        self.level = float(level)
        return out


class Sidetone:
    """Streaming sidetone: pitch oscillator x keying envelope
    (parity sound.c:679 quisk_make_sidetone)."""

    def __init__(self, fs: float, pitch_hz: float = 600.0,
                 level: float = 0.3, rise_ms: float = 5.0):
        self.fs = fs
        self.w = 2.0 * np.pi * pitch_hz / fs
        self.phase = 0.0
        self.level = level
        self.env = KeyEnvelope(fs, rise_ms)

    def process(self, key: np.ndarray) -> np.ndarray:
        n = len(key)
        ph = self.phase + self.w * np.arange(n)
        self.phase = float((ph[-1] + self.w) % (2.0 * np.pi))
        env = self.env.process(key)
        return (self.level * env * np.sin(ph)).astype(np.float32)


class KeyJitterBuffer:
    """Remote-CW event queue: timestamped key transitions are replayed
    ``delay_ms`` later so network jitter up to the delay never distorts
    element timing (parity ac2yd/remote_common.py:78-82, 20 ms).
    """

    def __init__(self, fs: float, delay_ms: float = 20.0):
        self.fs = fs
        self.delay = delay_ms * 1e-3
        self.events: list[tuple[float, bool]] = []   # (time_s, down)
        self.state = False
        self.clock = 0.0            # playback clock, seconds

    def push(self, t_sent: float, down: bool) -> None:
        self.events.append((t_sent + self.delay, down))
        self.events.sort()

    def render(self, n: int) -> np.ndarray:
        """Next n samples of the 0/1 key waveform."""
        out = np.empty(n, np.float32)
        t0 = self.clock
        for i in range(n):
            t = t0 + i / self.fs
            while self.events and self.events[0][0] <= t:
                self.state = self.events.pop(0)[1]
            out[i] = 1.0 if self.state else 0.0
        self.clock = t0 + n / self.fs
        return out


class SerialKey:
    """Serial-port CW key / PTT via the CTS and DSR modem-status bits.

    Parity: is_key_down.c — ``quisk_open_key(port, cts, dsr)`` configures
    each modem bit as 'None'/'CW'/'PTT' with optional "when low" polarity
    (is_key_down.c:24-61); ``quisk_poll_hardware_key`` (is_key_down.c:73)
    reads the bits every sound-loop iteration (sound.c:898) and sets
    ``quisk_serial_key_down`` / ``quisk_serial_ptt``.  The POSIX reference
    reads the bits with ``ioctl(TIOCMGET)``; so does this class.

    ``cts``/``dsr`` are the reference's config strings, e.g. "CW when high",
    "PTT when low", "None".  ``read_bits`` is injectable for tests (and for
    hardware backends that report key state out-of-band): a callable
    returning ``(cts_bit, dsr_bit)``.
    """

    def __init__(self, port: str = "", cts: str = "None", dsr: str = "None",
                 read_bits=None):
        self.use_cts, self.rev_cts = self._parse(cts)
        self.use_dsr, self.rev_dsr = self._parse(dsr)
        self.key_down = False
        self.ptt = False
        self.fd = -1
        self._read_bits = read_bits
        self.error = ""
        if read_bits is None and port:
            try:
                import os
                self.fd = os.open(port, os.O_RDWR | os.O_NOCTTY | os.O_NONBLOCK)
            except OSError as e:                 # startup_error=1 path
                self.error = f"open {port}: {e.strerror}"

    @staticmethod
    def _parse(s: str):
        use = (s or "N")[0].upper()              # 'N', 'C', 'P'
        return (use if use in "CP" else "N"), ("when low" in (s or ""))

    @property
    def in_use(self) -> bool:
        """quisk_use_serial_port: a bit is configured and the port opened."""
        ok = self._read_bits is not None or self.fd >= 0
        return ok and (self.use_cts != "N" or self.use_dsr != "N")

    def _modem_bits(self):
        if self._read_bits is not None:
            return self._read_bits()
        if self.fd < 0:
            return 0, 0
        import fcntl
        import struct as _struct
        import termios
        try:
            buf = fcntl.ioctl(self.fd, termios.TIOCMGET, _struct.pack("I", 0))
            bits = _struct.unpack("I", buf)[0]
        except OSError:                          # e.g. a pty: no modem bits
            return 0, 0
        return bits & termios.TIOCM_CTS, bits & termios.TIOCM_DSR

    def poll(self) -> tuple[bool, bool]:
        """One quisk_poll_hardware_key: -> (key_down, ptt)."""
        if not self.in_use:
            return self.key_down, self.ptt
        cts, dsr = self._modem_bits()
        if self.use_cts == "C":
            self.key_down = (not cts) if self.rev_cts else bool(cts)
        elif self.use_cts == "P":
            self.ptt = (not cts) if self.rev_cts else bool(cts)
        if self.use_dsr == "C":
            self.key_down = (not dsr) if self.rev_dsr else bool(dsr)
        elif self.use_dsr == "P":
            self.ptt = (not dsr) if self.rev_dsr else bool(dsr)
        return self.key_down, self.ptt

    def close(self) -> None:
        if self.fd >= 0:
            import os
            os.close(self.fd)
            self.fd = -1
