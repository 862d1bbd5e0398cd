"""MIDI input: device transport + radio control dispatch.

Parity: the reference reads MIDI bytes from the sound system every sound
loop (quisk.c:5570 quisk_control_midi -> ALSA/WASAPI rawmidi readers) and
hands them to midi_handler.py's ``MidiHandler.OnReadMIDI`` which maps

- Note On/Off  -> named buttons via a note dictionary; PTT is momentary
  unless ``midi_ptt_toggle`` (midi_handler.py:55-73)
- Control Change whose mapped name ends in " +N"/" -N" -> a jog wheel
  with a per-speed step table (midi_handler.py:120-146 JogWheel,
  tune_speed {0:10 .. 9:10000}; frequency snapped to a step multiple,
  VFO recentered when the result leaves the 45% passband)
- other Control Change -> absolute knobs (midi_handler.py:93-118
  ControlKnob: value/127 across the control's range; "Tune" spans
  sample_rate * 0.98 around the VFO)
- a MIDI CW key (quisk.c:5819 IS_SW_CWKEY includes quisk_midi_cwkey)

Here the transport is a byte-stream reader (``MidiInput``: any readable
fd — /dev/midi*, an ALSA rawmidi node, a FIFO or pipe for tests) feeding
the running-status ``MidiParser`` (app/interop.py), and the dispatch is
``MidiRadioController`` driving a live :class:`Radio` through its public
data-only control methods.  ``Radio.enable_midi`` polls it once per
``run_once`` iteration, exactly where the reference polls its device.
"""

from __future__ import annotations

import os

from quisk_tpu_torch.app.interop import MidiEvent, MidiParser


class MidiInput:
    """Non-blocking byte transport feeding a :class:`MidiParser`.

    ``source`` may be a device path (opened O_RDONLY|O_NONBLOCK), an
    already-open fd (int), or None for a transport-less instance fed via
    :meth:`feed` (tests, or an external reader thread)."""

    def __init__(self, source: str | int | None = None):
        self.parser = MidiParser()
        self._owned = False
        if source is None:
            self.fd = None
        elif isinstance(source, int):
            self.fd = source
            os.set_blocking(self.fd, False)
        else:
            self.fd = os.open(source, os.O_RDONLY | os.O_NONBLOCK)
            self._owned = True
        self._pending: list[MidiEvent] = []

    def feed(self, data: bytes) -> None:
        """Inject bytes directly (no fd): queued for the next poll."""
        self._pending.extend(self.parser.feed(data))

    def poll(self) -> list[MidiEvent]:
        """Drain available bytes; returns complete events (never blocks)."""
        out, self._pending = self._pending, []
        if self.fd is not None:
            while True:
                try:
                    chunk = os.read(self.fd, 1024)
                except BlockingIOError:
                    break
                except OSError:
                    break
                if not chunk:
                    break
                out.extend(self.parser.feed(chunk))
                if len(chunk) < 1024:
                    break
        return out

    def close(self) -> None:
        if self.fd is not None and self._owned:
            try:
                os.close(self.fd)
            except OSError:
                pass
        self.fd = None


class MidiRadioController:
    """Dispatch parsed MIDI events onto a live Radio.

    Bindings use the reference's *name* vocabulary: a note number maps to
    a named action ("PTT", "CWKey", "Mute", "Band 40", ...); a controller
    number maps either to an absolute knob name ("Tune", "Vol", "Sqlch",
    "Sidetone") or a jog name with the reference's " +speed"/" -speed"
    suffix ("Tune +3") selecting a step from the speed tables
    (midi_handler.py:20-21)."""

    #: jog step per speed digit (midi_handler.py:20 tune_speed)
    TUNE_SPEED = {0: 10, 1: 20, 2: 50, 3: 100, 4: 200,
                  5: 500, 6: 1000, 7: 2000, 8: 5000, 9: 10000}
    #: slider step per speed digit (midi_handler.py:21 slider_speed)
    SLIDER_SPEED = {0: 1, 1: 2, 2: 3, 3: 5, 4: 7,
                    5: 9, 6: 12, 7: 15, 8: 18, 9: 22}

    def __init__(self, radio, ptt_toggle: bool = False):
        self.radio = radio
        self.ptt_toggle = bool(ptt_toggle)
        self.note_map: dict[int, str] = {}
        self.cc_map: dict[int, str] = {}
        # sliders held as 0..100 ints like the reference's wx sliders so
        # jog steps compose (AdjSlider midi_handler.py:147-158)
        self._sliders = {"Vol": 100, "Sqlch": 0, "Sidetone": 30}

    # ---- binding ---------------------------------------------------------
    def bind_note(self, note: int, action: str) -> None:
        self.note_map[int(note)] = action

    def bind_cc(self, cc: int, action: str) -> None:
        self.cc_map[int(cc)] = action

    def bind_default(self) -> None:
        """A usable default surface: PTT on note 0x14, CW key on 0x15,
        mute 0x16, jog tune on CC 1, volume knob CC 7, squelch CC 8."""
        self.bind_note(0x14, "PTT")
        self.bind_note(0x15, "CWKey")
        self.bind_note(0x16, "Mute")
        self.bind_cc(1, "Tune +3")
        self.bind_cc(7, "Vol")
        self.bind_cc(8, "Sqlch")

    # ---- dispatch --------------------------------------------------------
    def dispatch(self, events: list[MidiEvent]) -> None:
        for e in events:
            if e.kind == "note_on":
                self._note(self.note_map.get(e.number), True)
            elif e.kind == "note_off":
                self._note(self.note_map.get(e.number), False)
            elif e.kind == "control":
                name = self.cc_map.get(e.number)
                if not name:
                    continue
                if (len(name) > 3 and name[-3] == " "
                        and name[-2] in "+-" and name[-1].isdigit()):
                    self._jog(name, e.value)
                else:
                    self._knob(name, e.value)

    def _note(self, action: str | None, down: bool) -> None:
        r = self.radio
        if action is None:
            return
        if action == "PTT":
            if self.ptt_toggle:
                if down:
                    r.set_ptt(not r.manual_ptt)
            else:
                r.set_ptt(down)      # momentary (midi_handler.py:60-63)
        elif action == "CWKey":
            r.set_cw_key(down)       # quisk.c:5819 quisk_midi_cwkey
        elif action == "Mute":
            if down:
                r.set_mute(not r.muted)
        elif action.startswith("Band ") and down:
            r.set_band(action[5:])
        elif action.startswith("Mode ") and down:
            r.set_mode(action[5:])
        elif action.startswith("Fav ") and down:
            r.tune_favorite(int(action[4:]))

    def _knob(self, name: str, value: int) -> None:
        """Absolute controls: value/127 over the control's span
        (midi_handler.py:93-118; value==64 is exact center)."""
        r = self.radio
        dec = 0.5 if value == 64 else value / 127.0
        if name == "Tune":
            # span 98% of the capture bandwidth around the VFO
            tune = r.cfg.sample_rate * (dec - 0.5) * 0.98
            r.set_frequency(r.vfo_hz + int(tune))
        elif name == "Vol":
            self._sliders["Vol"] = int(round(dec * 100))
            r.set_volume(dec)
        elif name == "Sidetone":
            self._sliders["Sidetone"] = int(round(dec * 100))
            r.set_sidetone(dec)
        elif name == "Sqlch":
            self._sliders["Sqlch"] = int(round(dec * 100))
            self._apply_squelch()

    def _jog(self, name: str, value: int) -> None:
        """Relative encoders, reference JogWheel semantics
        (midi_handler.py:120-146): speed digit picks the step, encoder
        direction from value<64, frequency snapped to a step multiple;
        set_frequency recenters the VFO when off-screen (its own 45%
        rule matches ChangeHwFrequency's)."""
        r = self.radio
        speed = int(name[-1])
        direction = 1 if name[-2] == "+" else -1
        base = name[:-3]
        if value >= 64:
            direction = -direction
        if base == "Tune":
            delta = self.TUNE_SPEED[speed]
            freq = r.freq_hz + direction * delta
            freq = ((freq + delta // 2) // delta) * delta
            r.set_frequency(freq)
        elif base in self._sliders:
            step = self.SLIDER_SPEED[speed]
            v = int(min(100, max(0, self._sliders[base] + direction * step)))
            self._sliders[base] = v
            if base == "Vol":
                r.set_volume(v / 100.0)
            elif base == "Sidetone":
                r.set_sidetone(v / 100.0)
            else:
                self._apply_squelch()

    def _apply_squelch(self) -> None:
        try:
            self.radio.set_squelch_level(self._sliders["Sqlch"] / 100.0 * 6.0)
        except KeyError:
            pass                     # chain built without a squelch
