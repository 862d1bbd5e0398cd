"""Headless widget models — quisk_widgets.py without wx.

The reference builds its control surface from a custom widget toolkit
(quisk_widgets.py, 1575 LoC): a frequency display tuned digit-by-digit
with accelerating click-and-hold repeats, labeled sliders, push/repeat/
check/cycle buttons, radio groups, a bit field for hardware registers,
and a validating frequency entry.  Those behaviors are *semantics*, not
pixels — so here each widget is a toolkit-agnostic model object: it
holds state, applies the reference's interaction rules, fires a command
callback, and serializes to JSON for any frontend (the web UI renders
the tree and routes DOM events back as ``{"cmd": "widget", ...}``).

Per-class parity:

- :func:`freq_format` — quisk_widgets.py:96 FreqFormatter.
- :class:`FrequencyDisplay` — 115-220: digit index from position,
  ChangeFreq's zero-below-digit +/- 10^i rule with the 10^(i-1) floor,
  wheel tuning, and the 300 -> 150 -> (-5 ms each, floor 20) hold-repeat
  schedule (OnTimer, 208-214); Clip turns the display pink (141-147).
- :class:`Slider` — 221-375 SliderBoxH/V: min/max/scale, %-format
  display text, decimal 0..1 get/set.
- :class:`PushButton` / :class:`RepeatButton` — 576/614: repeat fires
  once on press, again after 300 ms, then every 150 ms until release.
- :class:`CheckButton` — 681: a toggle with up/down state.
- :class:`CycleButton` — 1107: left-click cycles forward (wrapping),
  right-click backward, double-click resets to index 0; with
  ``is_radio`` it only cycles while already down.
- :class:`RadioGroup` — 1193 RadioButtonGroup: exactly-one-of a mixed
  list of plain and cycle buttons.
- :class:`BitField` — 730 QuiskBitField: n-bit register, click toggles
  one bit, value as int.
- :class:`FreqEntry` — 1468 FreqSetter: '.'-containing text parses as
  MHz, plain digits as Hz, clamped to [fmin, fmax]; spin steps 1 kHz.

:func:`standard_panel` assembles the reference main-screen control set
bound to a live :class:`~quisk_tpu_torch.app.radio.Radio`.
"""

from __future__ import annotations


def freq_format(freq) -> str:
    """Format 14234500 as '14 234 500' (FreqFormatter, quisk_widgets:96)."""
    freq = int(round(float(freq)))
    sign = "-" if freq < 0 else ""
    txt = "%d" % abs(freq)
    out = ""
    while len(txt) > 3:
        out = " " + txt[-3:] + out
        txt = txt[:-3]
    return sign + txt + out


class Widget:
    """Base: a named model with a command callback and JSON form."""

    kind = "widget"

    def __init__(self, name: str, command=None):
        self.name = name
        self.command = command
        self.enabled = True

    def _fire(self):
        if self.command:
            self.command(self)

    def to_json(self) -> dict:
        return {"kind": self.kind, "name": self.name,
                "enabled": self.enabled}

    def handle(self, event: str, **kw) -> None:
        """Route one frontend event by name ('press', 'digit', ...)."""
        fn = getattr(self, "on_" + event, None)
        if fn is not None and self.enabled:
            fn(**kw)


class FrequencyDisplay(Widget):
    """The big frequency readout, tuned digit-by-digit."""

    kind = "freq_display"

    def __init__(self, name="freq", command=None, freq=7_000_000):
        super().__init__(name, command)
        self.freq = int(freq)
        self.clip = False
        self._repeat_ms = 0

    @property
    def label(self) -> str:
        return freq_format(self.freq) + " Hz"

    def display(self, freq) -> None:
        self.freq = int(round(float(freq)))

    def set_clip(self, clip: bool) -> None:
        """ADC-clip indicator: the reference turns the display deep pink
        (Clip, quisk_widgets.py:141)."""
        self.clip = bool(clip)

    def change_digit(self, index: int, up: bool) -> int:
        """ChangeFreq (quisk_widgets.py:193-206): zero everything below
        digit ``index``, step by 10^index, floor at 10^(index-1) instead
        of going to zero or negative."""
        freq = (self.freq // 10 ** index) * 10 ** index
        if up:
            freq += 10 ** index
        else:
            freq -= 10 ** index
            if freq <= 0 and index > 0:
                freq = 10 ** (index - 1)
        self.freq = freq
        self._fire()
        return freq

    def on_digit(self, index: int, up: bool = True) -> None:
        """A digit click: change now and arm the hold-repeat."""
        self.change_digit(int(index), bool(up))
        self._repeat_ms = 300          # first push (OnLeftDown, :189)

    def on_wheel(self, index: int, up: bool = True) -> None:
        self.change_digit(int(index), bool(up))

    def on_release(self) -> None:
        self._repeat_ms = 0

    def next_repeat_ms(self) -> int | None:
        """The accelerating hold schedule (OnTimer, quisk_widgets.py:
        208-214): 300 once, then 150, then 5 ms faster each repeat with
        a 20 ms floor.  Returns the delay before the NEXT repeat, or
        None when the button is up."""
        if not self._repeat_ms:
            return None
        if self._repeat_ms == 300:
            self._repeat_ms = 150
        elif self._repeat_ms > 20:
            self._repeat_ms -= 5
        return self._repeat_ms

    def to_json(self):
        return {**super().to_json(), "freq": self.freq,
                "label": self.label, "clip": self.clip}


class Slider(Widget):
    """SliderBoxH/V: integer slider [themin, themax] with a formatted
    readout at value * scale."""

    kind = "slider"

    def __init__(self, name, text="%d", init=0, themin=0, themax=100,
                 command=None, scale=1):
        super().__init__(name, command)
        self.text = text
        self.themin, self.themax = int(themin), int(themax)
        self.scale = scale
        self.value = int(init)

    @property
    def label(self) -> str:
        if "%" in self.text:
            return self.text % (self.value * self.scale)
        return self.text

    def on_set(self, value) -> None:
        self.value = int(min(max(int(value), self.themin), self.themax))
        self._fire()

    def set_value(self, value) -> None:
        """Move the knob without firing (SliderBoxH.SetValue)."""
        self.value = int(min(max(int(value), self.themin), self.themax))

    def get_dec_value(self) -> float:
        return (self.value - self.themin) / float(self.themax - self.themin)

    def set_dec_value(self, dec: float, do_cmd: bool = True) -> None:
        self.value = int(round(self.themin
                               + dec * (self.themax - self.themin)))
        if do_cmd:
            self._fire()

    def to_json(self):
        return {**super().to_json(), "value": self.value,
                "min": self.themin, "max": self.themax,
                "label": self.label}


class PushButton(Widget):
    kind = "push"

    def on_press(self) -> None:
        self._fire()

    def to_json(self):
        return {**super().to_json(), "label": self.name}


class RepeatButton(PushButton):
    """Fires on press, again after 300 ms, then every 150 ms while held
    (QuiskRepeatbutton.OnTimer, quisk_widgets.py:659-663)."""

    kind = "repeat"

    def __init__(self, name, command=None, up_command=None):
        super().__init__(name, command)
        self.up_command = up_command
        self._state = 0

    def on_press(self) -> None:
        self._fire()
        self._state = 1

    def on_release(self) -> None:
        self._state = 0
        if self.up_command:
            self.up_command(self)

    def next_repeat_ms(self) -> int | None:
        if not self._state:
            return None
        if self._state == 1:
            self._state = 2
            return 300
        self._fire()
        return 150


class CheckButton(Widget):
    """A toggle (QuiskCheckbutton)."""

    kind = "check"

    def __init__(self, name, command=None, down=False, label=None):
        super().__init__(name, command)
        self.down = bool(down)
        self._label = label if label is not None else name

    @property
    def label(self) -> str:
        return self._label

    @label.setter
    def label(self, value: str) -> None:
        self._label = value

    def on_press(self) -> None:
        self.down = not self.down
        self._fire()

    def set_value(self, down: bool, do_cmd: bool = False) -> None:
        self.down = bool(down)
        if do_cmd:
            self._fire()

    def to_json(self):
        return {**super().to_json(), "label": self.label, "down": self.down}


class CycleButton(CheckButton):
    """Cycles its label on each push (QuiskCycleCheckbutton): left-click
    forward with wrap, right-click backward, double-click resets to 0;
    ``is_radio`` buttons only cycle while already selected."""

    kind = "cycle"

    def __init__(self, name, labels, command=None, is_radio=False):
        super().__init__(name, command)
        self.labels = list(labels)
        self.index = 0
        self.direction = 0
        self.is_radio = is_radio

    @property
    def label(self) -> str:
        return self.labels[self.index]

    def set_index(self, index: int, do_cmd: bool = False) -> None:
        self.index = int(index)
        self.down = self.index != 0
        if do_cmd:
            self._fire()

    def set_label(self, label: str, do_cmd: bool = False) -> None:
        self.set_index(self.labels.index(label), do_cmd)

    def on_press(self) -> None:
        if not self.is_radio or self.down:
            self.direction = 1
            self.set_index((self.index + 1) % len(self.labels))
        else:
            self.direction = 0
            self.down = True
        self._fire()

    def on_right(self) -> None:
        if not self.is_radio or self.down:
            self.direction = -1
            self.set_index((self.index - 1) % len(self.labels))
            self._fire()

    def on_dclick(self) -> None:
        if not self.is_radio or self.down:
            self.direction = 1
            self.set_index(0)
            self._fire()

    def to_json(self):
        return {**super().to_json(), "label": self.label,
                "labels": self.labels, "index": self.index}


class RadioGroup:
    """Exactly-one-of a row of buttons (RadioButtonGroup): a label given
    as a list becomes a cycle button inside the group."""

    def __init__(self, name, command, labels, default=None):
        self.name = name
        self.command = command
        self.buttons = []
        for lab in labels:
            if isinstance(lab, (list, tuple)):
                b = CycleButton("%s.%s" % (name, lab[0]), lab,
                                self._on_child, is_radio=True)
            else:
                b = CheckButton("%s.%s" % (name, lab), self._on_child)
                b.label = lab
            self.buttons.append(b)
        self.selected = None
        if default is not None:
            self.set_label(default)

    def _find(self, label):
        for b in self.buttons:
            if isinstance(b, CycleButton):
                if label in b.labels:
                    return b
            elif b.name.split(".", 1)[1] == label:
                return b
        return None

    def _on_child(self, child) -> None:
        for b in self.buttons:
            if b is not child:
                b.down = False
                if isinstance(b, CycleButton):
                    b.index = 0
        child.down = True
        self.selected = (child.label if isinstance(child, CycleButton)
                         else child.name.split(".", 1)[1])
        if self.command:
            self.command(self)

    def set_label(self, label: str, do_cmd: bool = False) -> None:
        b = self._find(label)
        if b is None:
            return
        for other in self.buttons:
            other.down = False
        if isinstance(b, CycleButton):
            b.set_index(b.labels.index(label))
        b.down = True
        self.selected = label
        if do_cmd and self.command:
            self.command(self)

    def get_label(self):
        return self.selected

    def to_json(self):
        return {"kind": "group", "name": self.name,
                "selected": self.selected,
                "buttons": [b.to_json() for b in self.buttons]}

    def handle(self, event, button=None, **kw):
        for b in self.buttons:
            if b.name == button:
                b.handle(event, **kw)
                return


class BitField(Widget):
    """An n-bit register control (QuiskBitField): click toggles a bit."""

    kind = "bits"

    def __init__(self, name, numbits, value=0, command=None):
        super().__init__(name, command)
        self.numbits = int(numbits)
        self.value = int(value)

    def on_bit(self, bit: int) -> None:
        self.value ^= 1 << int(bit)
        self._fire()

    def to_json(self):
        return {**super().to_json(), "numbits": self.numbits,
                "value": self.value}


class FreqEntry(Widget):
    """Validating frequency text entry (FreqSetter): text with a '.'
    parses as MHz, plain digits as Hz; clamped to [fmin, fmax]; spin
    steps are 1 kHz."""

    kind = "freq_entry"

    def __init__(self, name, fmin, fmax, freq, command=None, label=""):
        super().__init__(name, command)
        self.fmin, self.fmax = int(fmin), int(fmax)
        self.label = label or name
        self.freq = 0
        self.set_freq(freq)

    def set_freq(self, freq) -> None:
        self.freq = int(min(max(int(freq), self.fmin), self.fmax))

    def on_enter(self, text: str) -> None:
        text = str(text).replace(" ", "")
        if "-" in text:
            return
        try:
            if "." in text:
                freq = int(float(text) * 1_000_000 + 0.5)
            else:
                freq = int(text)
        except ValueError:
            return
        self.set_freq(freq)
        self._fire()

    def on_spin(self, khz: int) -> None:
        self.set_freq(int(khz) * 1000)
        self._fire()

    def to_json(self):
        return {**super().to_json(), "freq": self.freq,
                "text": freq_format(self.freq), "label": self.label,
                "min": self.fmin, "max": self.fmax}


class WidgetPanel:
    """An ordered widget tree with JSON serialization and event routing
    (the wx screen layout's control-plane equivalent)."""

    def __init__(self):
        self.widgets: dict[str, object] = {}

    def add(self, widget):
        self.widgets[widget.name] = widget
        return widget

    def __getitem__(self, name):
        return self.widgets[name]

    def to_json(self) -> list:
        return [w.to_json() for w in self.widgets.values()]

    def dispatch(self, name: str, event: str, **kw) -> bool:
        """Route one frontend event to widget ``name``; False if no such
        widget (malformed events are dropped like the web UI's other
        commands)."""
        w = self.widgets.get(name)
        if w is None:
            return False
        w.handle(event, **kw)
        return True


def standard_panel(radio) -> WidgetPanel:
    """The reference main screen's control set as widget models bound to
    a live Radio (quisk.py:5061-5225 button rows: band group, mode group,
    frequency display, Vol slider, RIT, Split, Mute, Spot, memory
    buttons)."""
    p = WidgetPanel()
    fd = p.add(FrequencyDisplay(
        "freq", lambda w: radio.set_frequency(float(w.freq)),
        freq=int(radio.freq_hz)))
    p.add(FreqEntry("entry", 0, 1_500_000_000, int(radio.freq_hz),
                    lambda w: radio.set_frequency(float(w.freq)),
                    label="Frequency"))
    bands = [b for b in ("160", "80", "60", "40", "30", "20", "17",
                         "15", "12", "10") if b in radio.BAND_EDGES]
    p.add(RadioGroup("band", lambda g: radio.set_band(g.get_label()),
                     bands, default=getattr(radio, "band", None)))
    from quisk_tpu_torch.app.webui import MODES
    p.add(RadioGroup("mode", lambda g: radio.set_mode(g.get_label()),
                     MODES, default=radio.cfg.mode))
    p.add(Slider("Vol", "Vol %3d", int(radio.volume * 100), 0, 100,
                 lambda w: radio.set_volume(w.value / 100.0)))
    p.add(CheckButton("Mute", lambda w: radio.set_mute(w.down),
                      down=radio.muted))
    p.add(Slider("RIT", "RIT %+5d", int(radio.rit_hz), -2000, 2000,
                 lambda w: radio.set_rit(float(w.value),
                                         on=bool(w.value))))
    p.add(CycleButton("Split", ["Split", "Split 1", "Split 2",
                                "Split 3", "Split 4"],
                      lambda w: radio.set_split(w.index > 0,
                                                play=max(1, w.index))))
    p.add(CheckButton("PTT", lambda w: radio.set_ptt(w.down)))
    # DSP stage buttons for whatever optional stages the chain was built
    # with (quisk.py:4917-4960 main-screen row) — toggled live as data
    ons = getattr(getattr(radio, "chain", None), "ons", {})
    if "nb" in ons:
        p.add(CycleButton("NB", ["NB", "NB 1", "NB 2", "NB 3"],
                          lambda w: radio.set_nb_level(w.index)))
    for key, lab in (("notch", "Notch"), ("nr", "NR2"), ("anf", "ANF"),
                     ("agc", "AGC"), ("squelch", "Sqlch"),
                     ("fm_sq", "FMsq")):
        if key in ons:
            p.add(CheckButton(
                lab, (lambda k: lambda w: radio.set_stage(k, w.down))(key),
                down=radio.chain.stage_on(key)))
    p.add(PushButton("MemSave", lambda w: radio.save_memory()))
    p.add(PushButton("MemNext", lambda w: radio.next_memory()))
    p.add(PushButton("MemDel", lambda w: radio.delete_memory()))

    def _sync(w=None):
        fd.display(radio.freq_hz)
    radio._widget_sync = _sync          # callers may refresh after retunes
    return p
