"""Favorites table, memory stations, and the station-markers row.

Parity with three reference surfaces:

- **Favorites** (quisk.py:1757 ConfigFavorites): a table of
  name / frequency (MHz) / mode / description / repeater offset (kHz) /
  CTCSS tone (Hz), persisted as ``|``-separated lines in
  ``quisk_favorites.txt`` (WriteOut/ReadIn, quisk.py:1833-1875; entries
  saved in Hz by very old versions are corrected to MHz on read,
  quisk.py:1845-1852).  Rows with an offset feed the repeater dictionary
  (MakeRepeaterDict, quisk.py:1945-1967) used for the FM repeater TX
  shift + CTCSS on key-down (quisk.py:6677-6689).
- **Memory stations** (quisk.py:3825 memoryState + 6228-6264): a sorted
  list of (freq, band, vfo, tx_offset, mode) snapshots with save /
  next-cycle / delete / recall semantics, shown on the station row.
- **StationScreen** (quisk.py:2598, contributed by DJ4CM): the ribbon
  under the graph marking favorites, memories, and DX-cluster spots in
  the displayed span, click-to-tune.  Here :func:`station_markers`
  returns those rows as data for the web UI to draw.
"""

from __future__ import annotations

import dataclasses
import os


@dataclasses.dataclass
class Favorite:
    name: str = ""
    freq_mhz: float = 0.0
    mode: str = ""
    description: str = ""
    offset_khz: str = ""      # repeater TX offset; "" = not a repeater
    tone_hz: str = ""         # CTCSS tone; "" = none

    @property
    def freq_hz(self) -> int:
        return int(round(self.freq_mhz * 1e6))


def _format_mhz(freq_mhz: float) -> str:
    """The reference's FormatFloat (quisk.py:1826): 6 decimals with up to
    three trailing zeros removed."""
    txt = "%.6f" % freq_mhz
    for _ in range(3):
        if txt.endswith("0"):
            txt = txt[:-1]
    return txt


class Favorites:
    """The favorites table + file round-trip + repeater dictionary."""

    def __init__(self, path: str | None = None):
        self.path = path
        self.entries: list[Favorite] = []
        if path and os.path.exists(path):
            self.load(path)

    def load(self, path: str | None = None) -> None:
        path = path or self.path
        self.entries = []
        with open(path, "r") as fp:
            lines = fp.readlines()
        for line in lines:
            if not line.strip():
                continue
            fields = [f.strip() for f in line.split("|")]
            fields += [""] * (6 - len(fields))
            freq = fields[1]
            try:
                freq = float(freq)
            except ValueError:
                freq = 0.0
            if freq > 30000.0:        # old entry stored in Hertz
                freq *= 1e-6
            self.entries.append(Favorite(
                name=fields[0], freq_mhz=freq, mode=fields[2],
                description=fields[3], offset_khz=fields[4],
                tone_hz=fields[5]))

    def save(self, path: str | None = None) -> None:
        path = path or self.path
        with open(path, "w") as fp:
            for e in self.entries:
                fp.write("|".join((
                    e.name, _format_mhz(e.freq_mhz), e.mode,
                    e.description, str(e.offset_khz), str(e.tone_hz)))
                    + "\n")

    def add(self, name: str, freq_hz: float, mode: str = "",
            description: str = "", offset_khz="", tone_hz="") -> Favorite:
        fav = Favorite(name=name, freq_mhz=freq_hz * 1e-6, mode=mode,
                       description=description, offset_khz=str(offset_khz),
                       tone_hz=str(tone_hz))
        self.entries.append(fav)
        return fav

    def delete(self, index: int) -> None:
        del self.entries[index]

    def move(self, index: int, delta: int) -> None:
        """Move Up / Move Down popup items (quisk.py:1815-1818)."""
        j = index + delta
        if 0 <= j < len(self.entries):
            e = self.entries.pop(index)
            self.entries.insert(j, e)

    def repeater_dict(self) -> dict[int, tuple[float, float]]:
        """{freq rounded to 1 kHz (Hz): (offset_khz, tone_hz)} for rows
        with a repeater offset (MakeRepeaterDict, quisk.py:1945)."""
        out = {}
        for e in self.entries:
            off = str(e.offset_khz).strip()
            if not off:
                continue
            try:
                offset = float(off)
                tone = float(str(e.tone_hz).strip() or "0")
            except ValueError:
                continue
            freq = int(e.freq_mhz * 1e6 + 0.5)
            out[((freq + 500) // 1000) * 1000] = (offset, tone)
        return out


@dataclasses.dataclass
class MemoryStation:
    freq: int                 # absolute tuned frequency (VFO + offset)
    band: str
    vfo: int
    tx_offset: int            # the reference stores txFreq (VFO-relative)
    mode: str

    def to_list(self):
        return [self.freq, self.band, self.vfo, self.tx_offset, self.mode]


class MemoryBank:
    """Sorted memory-station list with the reference's button semantics
    (OnBtnMemSave/Next/Delete + popup, quisk.py:6228-6264)."""

    def __init__(self, saved=None):
        self.stations: list[MemoryStation] = [
            MemoryStation(int(s[0]), str(s[1]), int(s[2]), int(s[3]),
                          str(s[4])) for s in (saved or [])]

    def __len__(self):
        return len(self.stations)

    def to_list(self):
        return [s.to_list() for s in self.stations]

    def save(self, freq: float, band: str, vfo: float, tx_offset: float,
             mode: str) -> None:
        """Save-or-replace the entry at ``freq`` and keep the list sorted
        (OnBtnMemSave)."""
        entry = MemoryStation(int(freq), band, int(vfo), int(tx_offset),
                              mode)
        for i, s in enumerate(self.stations):
            if s.freq == entry.freq:
                self.stations[i] = entry
                return
        self.stations.append(entry)
        self.stations.sort(key=lambda s: s.freq)

    def next_after(self, freq: float) -> MemoryStation | None:
        """The MemNext button: first entry above ``freq``, wrapping to
        the lowest (OnBtnMemNext, quisk.py:6241-6248)."""
        if not self.stations:
            return None
        for s in self.stations:
            if s.freq > freq:
                return s
        return self.stations[0]

    def at_freq(self, freq: float) -> MemoryStation | None:
        for s in self.stations:
            if s.freq == int(freq):
                return s
        return None

    def delete(self, freq: float) -> bool:
        """Delete the entry at the current frequency (OnBtnMemDelete)."""
        for i, s in enumerate(self.stations):
            if s.freq == int(freq):
                del self.stations[i]
                return True
        return False


def station_markers(freq1: float, freq2: float, favorites=None,
                    memories=None, dx_spots=None) -> list[dict]:
    """The StationScreen row as data: favorites, memory stations, and DX
    spots inside (freq1, freq2), sorted by frequency (quisk.py:2646-2675;
    symbols f/m/dx mirror conf.Xsym_stat_fav/_mem/_dx)."""
    out = []
    for e in (favorites.entries if favorites else ()):
        if freq1 < e.freq_hz < freq2:
            out.append({"freq": e.freq_hz, "kind": "fav", "name": e.name,
                        "mode": e.mode, "descr": e.description})
    for s in (memories.stations if memories else ()):
        if freq1 < s.freq < freq2:
            out.append({"freq": s.freq, "kind": "mem", "name": "",
                        "mode": s.mode, "descr": ""})
    for sp in (dx_spots or ()):
        f = sp.freq_khz * 1e3
        if freq1 < f < freq2:
            out.append({"freq": f, "kind": "dx", "name": sp.dx_call,
                        "mode": "", "descr": "%s %s %s" % (
                            sp.spotter, sp.time_utc, sp.comment)})
    out.sort(key=lambda d: d["freq"])
    return out
