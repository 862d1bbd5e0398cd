"""Small interop clients: DX cluster spots and MIDI control.

Parity:
- dxcluster.py (189 LoC): telnet client that logs into a DX cluster node
  and parses "DX de ..." spot lines into (spotter, freq kHz, dx call,
  comment, time); the GUI shows spots on the band scale.
- midi_handler.py (161 LoC) + quisk.c:5570: MIDI note/controller messages
  mapped to radio controls (PTT, tuning knob, band buttons).

Both are transport-agnostic here: byte/line feeds in, parsed events out,
so tests run without sockets or ALSA.
"""

from __future__ import annotations

import dataclasses
import re


# --------------------------------------------------------------- DX spots
@dataclasses.dataclass
class DxSpot:
    spotter: str
    freq_khz: float
    dx_call: str
    comment: str
    time_utc: str


_SPOT_RE = re.compile(
    r"^DX de\s+(?P<spotter>[A-Z0-9/\-]+):?\s+"
    r"(?P<freq>\d+\.?\d*)\s+"
    r"(?P<dx>[A-Z0-9/\-]+)\s*"
    r"(?P<comment>.*?)\s*"
    r"(?P<time>\d{4}Z?)\s*$", re.IGNORECASE)


def parse_spot(line: str) -> DxSpot | None:
    """Parse one cluster line; None if it isn't a spot."""
    m = _SPOT_RE.match(line.strip())
    if not m:
        return None
    return DxSpot(spotter=m.group("spotter").rstrip(":").upper(),
                  freq_khz=float(m.group("freq")),
                  dx_call=m.group("dx").upper(),
                  comment=m.group("comment").strip(),
                  time_utc=m.group("time"))


class DxClusterClient:
    """Line-oriented cluster session: feed received bytes, collect spots,
    get login/keepalive bytes to send.  A real socket loop wraps this."""

    def __init__(self, callsign: str, keep: int = 100):
        self.callsign = callsign
        self.spots: list[DxSpot] = []
        self.keep = keep
        self._buf = b""
        self._sent_login = False

    def on_connect(self) -> bytes:
        self._sent_login = True
        return (self.callsign + "\r\n").encode()

    def feed(self, data: bytes) -> list[DxSpot]:
        """Feed received bytes; returns newly parsed spots."""
        self._buf += data
        new = []
        while b"\n" in self._buf:
            line, self._buf = self._buf.split(b"\n", 1)
            spot = parse_spot(line.decode("ascii", "replace"))
            if spot:
                new.append(spot)
        self.spots.extend(new)
        del self.spots[:-self.keep]
        return new


# ------------------------------------------------------------------ MIDI
@dataclasses.dataclass
class MidiEvent:
    kind: str          # "note_on" | "note_off" | "control" | "pitch"
    channel: int
    number: int        # note or controller number
    value: int


class MidiParser:
    """Running-status MIDI byte-stream parser (subset used for control
    surfaces: note on/off, control change, pitch bend)."""

    def __init__(self):
        self._status = 0
        self._data: list[int] = []

    def feed(self, data: bytes) -> list[MidiEvent]:
        out = []
        for b in data:
            if b >= 0xF8:              # realtime: ignore
                continue
            if b & 0x80:
                self._status = b
                self._data = []
                continue
            if not self._status:
                continue
            self._data.append(b)
            kind = self._status & 0xF0
            chan = self._status & 0x0F
            need = 1 if kind in (0xC0, 0xD0) else 2
            if len(self._data) < need:
                continue
            d = self._data
            self._data = []            # running status: keep self._status
            if kind == 0x90 and d[1] > 0:
                out.append(MidiEvent("note_on", chan, d[0], d[1]))
            elif kind == 0x80 or (kind == 0x90 and d[1] == 0):
                out.append(MidiEvent("note_off", chan, d[0], d[1]))
            elif kind == 0xB0:
                out.append(MidiEvent("control", chan, d[0], d[1]))
            elif kind == 0xE0:
                out.append(MidiEvent("pitch", chan, 0, d[0] | (d[1] << 7)))
        return out


class MidiControlMap:
    """Map MIDI events to radio actions (parity midi_handler.py): note ->
    named buttons (PTT, band switch), controller -> continuous knobs
    (tune step up/down via relative encoders, volume)."""

    def __init__(self):
        self.note_actions: dict[int, str] = {}
        self.cc_actions: dict[int, str] = {}
        self.handlers: dict[str, callable] = {}

    def bind_note(self, note: int, action: str):
        self.note_actions[note] = action

    def bind_cc(self, cc: int, action: str):
        self.cc_actions[cc] = action

    def on(self, action: str, fn):
        self.handlers[action] = fn

    def dispatch(self, events: list[MidiEvent]) -> None:
        for e in events:
            if e.kind in ("note_on", "note_off"):
                action = self.note_actions.get(e.number)
                if action and action in self.handlers:
                    self.handlers[action](e.kind == "note_on", e.value)
            elif e.kind == "control":
                action = self.cc_actions.get(e.number)
                if action and action in self.handlers:
                    # relative encoders send 1/127 style deltas
                    delta = e.value - 64 if e.value >= 64 else e.value
                    self.handlers[action](True, delta)
