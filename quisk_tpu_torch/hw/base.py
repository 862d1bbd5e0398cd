"""Hardware plugin base class and registry.

Parity: quisk_hardware_model.py — the reference defines one ``Hardware``
base class whose methods the app calls at well-known moments (open/close,
ChangeFrequency/ChangeMode/ChangeBand, HeartBeat ~10 Hz, variable-decimation
negotiation, GetRxSamples polling).  User configs may substitute any
subclass.  Here the same lifecycle, minus wx: methods return plain values,
and sample delivery is pull-based ``read_samples`` yielding ``[C, B]``
complex blocks of host memory, which the radio moves to its device.

This module registers the plugins that need no network or USB radio:
``fixed``, ``file``, ``loopback`` and ``sim``.  The network and USB radios
of the reference (hermes, hiqsdr, softrock, ...) belong to a later slice of
the port; asking for one raises a ``KeyError`` that says so.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

_REGISTRY: dict[str, Callable[..., "Hardware"]] = {}

#: the reference's network and USB plugins, not in this package yet
LATER_SLICE = frozenset({
    "afedri", "fifisdr", "hamlib", "hermes", "hiqsdr", "hl2_oob", "multus",
    "perseus", "sdr8600", "sdriq", "sdrmicron", "soapy", "softrock",
    "wideband"})


def register_hardware(name: str):
    """Class decorator: register a Hardware implementation under a key."""

    def deco(cls):
        _REGISTRY[name] = cls
        return cls

    return deco


def get_hardware(name: str) -> Callable[..., "Hardware"]:
    try:
        return _REGISTRY[name]
    except KeyError:
        if name in LATER_SLICE:
            raise KeyError(f"hardware {name!r} is a network/USB plugin of "
                           f"slice 7b of the port, not ported yet; known: "
                           f"{sorted(_REGISTRY)}") from None
        raise KeyError(f"unknown hardware {name!r}; known: {sorted(_REGISTRY)}")


class Hardware:
    """Lifecycle + control API (parity quisk_hardware_model.py:17-150).

    Subclasses override what their radio needs; every method has a safe
    default so a minimal plugin only implements ``open``/``read_samples``.
    """

    #: populated by open(): text shown to the user (ref: return of open())
    status_text: str = ""

    #: True when the radio's own TX DDS/mixer places the transmit signal
    #: at the requested tx_frequency (network radios: HiQSDR, Hermes).
    #: False = soundcard-style TX centered on a fixed VFO, so the host
    #: must rotate the outgoing IQ to the TX offset digitally — the
    #: reference's tx_mic_phase path (sound.c:708/1118).
    tx_dds: bool = True

    def __init__(self, conf=None):
        self.conf = conf
        self.vfo_frequency = 0
        self.tx_frequency = 0
        self.mode = "USB"
        self.band = ""

    # ---- lifecycle ------------------------------------------------------
    def pre_open(self) -> None:
        """Called before open (ref quisk.py:4279)."""

    def open(self) -> str:
        """Connect to the radio; return status text."""
        return self.status_text

    def post_open(self) -> None:
        """Called after the sample stream starts (ref quisk.py:4345)."""

    def close(self) -> None:
        pass

    # ---- control --------------------------------------------------------
    def ChangeFrequency(self, tx_freq: int, vfo_freq: int,
                        source: str = "", band: str = "") -> tuple[int, int]:
        """Request new tx/VFO frequency; returns what was actually set."""
        self.tx_frequency, self.vfo_frequency = tx_freq, vfo_freq
        return tx_freq, vfo_freq

    def ReturnFrequency(self) -> tuple[int | None, int | None]:
        """Hardware-initiated tuning (ref model: return None, None when
        the radio did not change frequency on its own)."""
        return None, None

    def RepeaterOffset(self, offset: float | None = None) -> bool:
        """FM repeater TX shift (hermes/quisk_hardware.py:524-540):
        ``offset`` kHz shifts the TX dial for the duration of the
        transmission, 0 restores the original dial, None polls whether
        the retune has settled (always True for this generic version —
        radios with slow synthesizers override)."""
        if offset is None:
            return True
        if offset == 0:
            if getattr(self, "_repeater_freq", None) is not None:
                self.ChangeFrequency(self._repeater_freq,
                                     self.vfo_frequency, "repeater")
                self._repeater_freq = None
        else:
            self._repeater_freq = self.tx_frequency
            self.ChangeFrequency(self.tx_frequency + int(offset * 1000),
                                 self.vfo_frequency, "repeater")
        return True

    def ChangeMode(self, mode: str) -> None:
        self.mode = mode

    def ChangeBand(self, band: str) -> None:
        self.band = band

    def OnButtonPTT(self, pressed: bool) -> None:
        pass

    def OnSpot(self, level: int) -> None:
        pass

    def HeartBeat(self) -> None:
        """Called ~10 Hz from the app loop (ref quisk.py:6832)."""

    # ---- variable decimation (ref VarDecim* negotiation) ----------------
    def VarDecimGetChoices(self) -> list[int]:
        """Selectable input sample rates, if the radio supports several."""
        return []

    def VarDecimGetIndex(self) -> int:
        return 0

    def VarDecimSet(self, index: int) -> float:
        """Choose a rate by index; returns the new input sample rate."""
        raise NotImplementedError

    # ---- sample plane ---------------------------------------------------
    def StartSamples(self) -> None:
        pass

    def StopSamples(self) -> None:
        pass

    def read_samples(self, n: int) -> np.ndarray | None:
        """Pull up to ``[n_rx, n]`` complex64 samples; None when starved."""
        return None

    def write_samples(self, iq: np.ndarray) -> None:
        """Accept one transmitted IQ block (the TX half of the sound loop:
        sound.c:1151-1186 play_samples / the UDP TX writers).  Network
        plugins override to frame and send; the default keeps the last
        block for taps/tests."""
        self.tx_iq_last = np.asarray(iq)


@register_hardware("fixed")
class FixedHardware(Hardware):
    """No-control hardware (parity quisk_hardware_fixed.py): frequencies
    are bookkeeping only; samples come from elsewhere (file/soundcard)."""


@register_hardware("file")
class FileHardware(Hardware):
    """IQ WAV replay (parity: the reference's FILE_PLAY_SAMPLES path,
    sound.c:987, quisk.c:1538-1576 — running the whole RX chain from a
    recorded file with no hardware)."""

    def __init__(self, conf=None, path: str | None = None, loop: bool = True):
        super().__init__(conf)
        self.path = path or getattr(conf, "playback_file", None)
        self.loop = loop
        self.iq = None
        self.pos = 0
        self.sample_rate = 0.0

    def open(self) -> str:
        from quisk_tpu_torch.io import wav
        self.iq, self.sample_rate = wav.read_iq_wav(self.path)
        self.iq = self.iq.astype(np.complex64)
        self.status_text = (f"file {self.path}: {len(self.iq)} samples "
                            f"@ {self.sample_rate:.0f} Hz")
        return self.status_text

    def read_samples(self, n: int) -> np.ndarray | None:
        if self.iq is None:
            return None
        out = np.empty(n, np.complex64)
        got = 0
        while got < n:
            take = min(n - got, len(self.iq) - self.pos)
            if take <= 0:
                if not self.loop:
                    return None if got == 0 else out[None, :got]
                self.pos = 0
                continue
            out[got:got + take] = self.iq[self.pos:self.pos + take]
            self.pos += take
            got += take
        return out[None]


@register_hardware("loopback")
class LoopbackHardware(Hardware):
    """RX hears your own transmission (the reference's DEBUG_MIC==1
    self-test, sound.c:886-888/1090-1099): write_samples stores the TX
    IQ through a compressive simulated PA; read_samples replays it
    shifted to the dial offset, with noise in the gaps."""

    def __init__(self, conf=None, offset_hz: float | None = None,
                 sample_rate: float | None = None, noise: float = 1e-4):
        super().__init__(conf)
        self.offset_hz = float(offset_hz if offset_hz is not None
                               else getattr(conf, "tune_hz", 9000.0))
        self.sample_rate = float(sample_rate if sample_rate is not None
                                 else getattr(conf, "sample_rate", 48000.0))
        self.noise = noise
        self._pending = np.zeros(0, np.complex64)
        self._phase = 0.0
        self._rng = np.random.default_rng(777)
        self._pa = None

    def open(self) -> str:
        from quisk_tpu_torch.tx.puresignal import SimulatedPA
        self._pa = SimulatedPA()
        self.status_text = f"TX->RX loopback @ {self.offset_hz:+.0f} Hz"
        return self.status_text

    def write_samples(self, iq: np.ndarray) -> None:
        super().write_samples(iq)
        fb = self._pa(np.asarray(iq)) if self._pa is not None else iq
        self._pending = np.concatenate([self._pending,
                                        fb.astype(np.complex64)])

    def read_samples(self, n: int) -> np.ndarray:
        take = min(n, len(self._pending))
        sig = np.zeros(n, np.complex64)
        sig[:take] = self._pending[:take]
        self._pending = self._pending[take:]
        w = 2.0 * np.pi * self.offset_hz / self.sample_rate
        ph = self._phase + w * np.arange(n)
        self._phase = float((ph[-1] + w) % (2.0 * np.pi))
        out = sig * np.exp(1j * ph)
        out += self.noise * (self._rng.standard_normal(n)
                             + 1j * self._rng.standard_normal(n))
        return out.astype(np.complex64)[None]


@register_hardware("sim")
class SimHardware(Hardware):
    """Synthetic signal source (parity: the reference's test tone
    AddTestTone quisk.c:1258 and IMD generators): emits a tone at a
    settable offset from the VFO plus noise — deterministic, for tests and
    demos."""

    def __init__(self, conf=None, sample_rate: float | None = None,
                 tone_hz: float = 10000.0, amplitude: float = 0.5,
                 noise: float = 1e-4, n_rx: int = 1):
        super().__init__(conf)
        if sample_rate is None:
            # follow the radio's configured rate: a fixed 48 k default
            # made the tone alias (e.g. 5.3 kHz read at 192 k shows at
            # 21.2 kHz) whenever the radio ran at any other rate
            sample_rate = float(getattr(conf, "sample_rate", 48000.0)
                                or 48000.0)
        self.sample_rate = sample_rate
        self.tone_hz = tone_hz
        self.amplitude = amplitude
        self.noise = noise
        self.n_rx = n_rx
        self._phase = 0.0
        self._rng = np.random.default_rng(12345)

    def open(self) -> str:
        self.status_text = f"sim source @ {self.sample_rate:.0f} Hz"
        return self.status_text

    def read_samples(self, n: int) -> np.ndarray:
        w = 2.0 * np.pi * self.tone_hz / self.sample_rate
        ph = self._phase + w * np.arange(n)
        self._phase = float((ph[-1] + w) % (2.0 * np.pi))
        sig = self.amplitude * np.exp(1j * ph)
        out = np.broadcast_to(sig, (self.n_rx, n)).copy()
        out += self.noise * (self._rng.standard_normal((self.n_rx, n))
                             + 1j * self._rng.standard_normal((self.n_rx, n)))
        return out.astype(np.complex64)
