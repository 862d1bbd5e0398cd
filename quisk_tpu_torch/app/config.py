"""Typed, documented, persistable configuration.

Parity: the reference's three-tier config (SURVEY.md §5.6) —
``quisk_conf_defaults.py`` (every flag with doc comments),
``configure.py``'s JSON radio database (``quisk_settings.json``), and a user
override file.  Here: frozen dataclasses with docstrings per category, JSON
(de)serialisation, named-radio storage, and periodic app-state snapshots
(band/frequency/mode persisted like quisk.py:3712 ``StateNames`` every 20 s).
"""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import time
from typing import Any

from quisk_tpu_torch.modes import Mode


@dataclasses.dataclass
class RadioConfig:
    """Everything needed to build RX/TX chains for one radio."""

    name: str = "default"
    sample_rate: float = 48000.0      # input IQ rate (quisk_conf_defaults sample_rate)
    audio_rate: float = 48000.0       # internal audio rate (48 k, quisk.c:1730)
    playback_rate: float = 48000.0    # device rate; x2/4/8 interp (quisk.c:2663)
    latency_ms: float = 150.0         # play buffer depth (quisk_conf_defaults:1738)
    tx_rate: float = 48000.0
    channels: int = 1                 # concurrent receivers (ref caps at 3+9)
    audio_block: int = 2048
    mode: str = "USB"
    bandwidth_hz: float | None = None
    tune_hz: float = 0.0
    agc: bool = True
    agc_release_db_per_s: float = 60.0
    squelch: bool = False
    squelch_threshold: float = 1.2
    noise_blanker: int = 0            # 0=off, 1/2/3 = level (quisk.c:716)
    auto_notch: bool = False
    nr: bool = False                  # spectral noise reduction (NR2)
    anf: bool = False                 # LMS auto-notch filter
    fm_squelch: bool = False          # RF-level squelch (quisk.c:2076)
    fm_squelch_db: float = -60.0
    fm_deviation_hz: float = 2500.0
    cw_pitch: float = 600.0
    filter_taps: int = 1025
    # raw-IQ conditioning (rx/frontend.py): DC removal bandwidth in Hz
    # (0 off, 1 window-average, >1 Lyons highpass — sound.c:188), spectrum
    # inversion (quisk.c:2442), and the I/Q balance trim slot (sound.c:171)
    dc_remove_bw: int = 0
    invert_spectrum: bool = False
    front_cond: bool = False          # force the conditioner on (for trims)
    # display
    fft_size: int = 2048
    graph_refresh_hz: float = 7.0     # quisk_conf_defaults.py:1794
    graph_window: str = "hann"        # spectrum window (wdsp/analyzer.c)
    graph_overlap: float = 0.0        # frame overlap (wdsp analyzer)

    def modes(self) -> Mode:
        return Mode[self.mode]

    def tx_chain_config(self):
        """Build the port's TxChainConfig this radio describes."""
        from quisk_tpu_torch.tx import TxChainConfig
        return TxChainConfig(
            channels=1, audio_rate=self.audio_rate, tx_rate=self.tx_rate,
            fm_deviation_hz=self.fm_deviation_hz)

    def rx_chain_config(self):
        """Build the port's RxChainConfig this radio describes."""
        from quisk_tpu_torch.rx import RxChainConfig
        return RxChainConfig(
            sample_rate=self.sample_rate, channels=self.channels,
            audio_rate=self.audio_rate, audio_block=self.audio_block,
            filter_taps=self.filter_taps, agc=self.agc,
            fm_deviation_hz=self.fm_deviation_hz, cw_pitch=self.cw_pitch,
            noise_blanker=self.noise_blanker, auto_notch=self.auto_notch,
            nr=self.nr, anf=self.anf, squelch=self.squelch,
            squelch_threshold=self.squelch_threshold,
            fm_squelch=self.fm_squelch, fm_squelch_db=self.fm_squelch_db,
            front_cond=(self.front_cond or self.invert_spectrum),
            dc_remove_bw=self.dc_remove_bw)

    def to_json(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict[str, Any]) -> "RadioConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    @classmethod
    def from_flags(cls, flags, name: str = "default") -> "RadioConfig":
        """Build chain config from the full flag surface
        (app/flags.py — the quisk_conf_defaults.py tunables)."""
        return cls(
            name=name,
            sample_rate=float(flags.sample_rate),
            playback_rate=float(flags.playback_rate or 48000),
            latency_ms=float(flags.lin_latency_millisecs),
            tx_rate=float(flags.mic_playback_rate),
            agc_release_db_per_s=60.0 / max(flags.agc_release_time, 1e-3),
            cw_pitch=float(flags.cwTone),
            graph_refresh_hz=float(flags.graph_refresh),
            graph_window=str(flags.graph_window),
            graph_overlap=float(flags.graph_overlap),
            dc_remove_bw=int(flags.dc_remove_bw),
            invert_spectrum=bool(flags.invertSpectrum),
        )


def default_settings_path() -> pathlib.Path:
    """The settings database location (the reference defaults
    ``quisk_settings.json`` next to the config file, configure.py:92-94):
    ``$QUISK_TPU_SETTINGS`` or ``~/.quisk_tpu/quisk_settings.json``."""
    env = os.environ.get("QUISK_TPU_SETTINGS")
    if env:
        return pathlib.Path(env)
    return pathlib.Path.home() / ".quisk_tpu" / "quisk_settings.json"


class Settings:
    """Named-radio JSON database + periodic app-state persistence
    (the quisk_settings.json equivalent, configure.py:92-94, 543, 588)."""

    STATE_KEYS = ("band", "vfo_hz", "tune_hz", "mode", "bandwidth_hz",
                  "volume", "agc", "squelch")   # ref StateNames quisk.py:3712

    def __init__(self, path: str | pathlib.Path):
        self.path = pathlib.Path(path)
        self.data: dict[str, Any] = {"radios": {}, "state": {}}
        self._last_save = 0.0
        if self.path.exists():
            self.data = json.loads(self.path.read_text())

    def save(self) -> None:
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.path.write_text(json.dumps(self.data, indent=1, sort_keys=True))
        self._last_save = time.monotonic()

    # -- radios ------------------------------------------------------------
    def add_radio(self, cfg: RadioConfig) -> None:
        self.data["radios"][cfg.name] = cfg.to_json()

    def get_radio(self, name: str) -> RadioConfig:
        return RadioConfig.from_json(self.data["radios"][name])

    # -- per-radio flag overrides (configure.py settings[4] equivalent) ----
    def set_flags(self, radio: str, flags) -> None:
        self.data.setdefault("flags", {})[radio] = flags.to_json()

    def get_flags(self, radio: str):
        from quisk_tpu_torch.app.flags import Flags
        return Flags.from_json(self.data.get("flags", {}).get(radio, {}))

    def radio_names(self) -> list[str]:
        return sorted(self.data["radios"])

    # -- app state (periodic snapshot) --------------------------------------
    def update_state(self, interval_secs: float = 20.0, **state) -> bool:
        """Record state; write to disk at most every `interval_secs`
        (the reference saves every 20 s, quisk.py:6883-6887).  Returns True
        if a disk write happened."""
        self.data["state"].update(state)
        if time.monotonic() - self._last_save >= interval_secs:
            self.save()
            return True
        return False

    def get_state(self) -> dict[str, Any]:
        return dict(self.data["state"])
