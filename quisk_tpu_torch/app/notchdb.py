"""Persistent manual-notch database (wdsp/nbp.c parity).

The reference's NBP ("notch-bank bandpass", wdsp/nbp.c) keeps a database
of notches at absolute RF frequencies; whenever the receiver tunes or the
bandpass changes, the channel filter is re-designed with every enabled
in-band notch carved out of its impulse response.  Here the database
lives on the host, and its in-band entries become extra ``(center,
width)`` pairs handed to ``RxChain.retune(notches_hz=...)`` — the carved
filter is pure data, so adding/removing/toggling a notch swaps a mask
tensor and rebuilds nothing.

Persistence: ``to_list``/``from_list`` round-trip through the Settings
JSON state (the reference persists the notch database across sessions the
same way, wdsp/nbp.c:direct database get/set setters).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Notch:
    freq_hz: float                 # absolute RF (dial) frequency
    width_hz: float = 100.0
    active: bool = True


class NotchDB:
    """Ordered list of manual notches at absolute RF frequencies."""

    def __init__(self, notches=()):
        self.notches: list[Notch] = [n if isinstance(n, Notch) else Notch(*n)
                                     for n in notches]

    def add(self, freq_hz: float, width_hz: float = 100.0,
            active: bool = True) -> Notch:
        n = Notch(float(freq_hz), float(width_hz), bool(active))
        self.notches.append(n)
        return n

    def remove(self, freq_hz: float, tol_hz: float = 1.0) -> int:
        """Remove all notches within tol of freq; returns count removed."""
        before = len(self.notches)
        self.notches = [n for n in self.notches
                        if abs(n.freq_hz - freq_hz) > tol_hz]
        return before - len(self.notches)

    def set_active(self, freq_hz: float, active: bool,
                   tol_hz: float = 1.0) -> None:
        for n in self.notches:
            if abs(n.freq_hz - freq_hz) <= tol_hz:
                n.active = active

    def baseband(self, center_hz: float, rit_hz: float = 0.0):
        """Active notches as (offset, width) pairs relative to a channel
        mixed down by ``center_hz`` (+ CW RIT): the channel filter's own
        frequency axis.  Out-of-band entries are dropped later by the
        designer, so everything active is returned."""
        return tuple((n.freq_hz - center_hz - rit_hz, n.width_hz)
                     for n in self.notches if n.active)

    # ---- JSON persistence ------------------------------------------------
    def to_list(self):
        return [[n.freq_hz, n.width_hz, n.active] for n in self.notches]

    @classmethod
    def from_list(cls, items) -> "NotchDB":
        return cls([Notch(float(f), float(w), bool(a))
                    for f, w, a in (items or [])])

    def __len__(self) -> int:
        return len(self.notches)
