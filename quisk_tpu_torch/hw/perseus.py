"""Microtelecom Perseus control plane.

Parity: perseuspkg/quisk_hardware.py (189 LoC) + perseuspkg/perseus.c —
the Perseus is a USB radio driven through libperseus-sdr: open, download
the FPGA bitstream for the chosen rate, then set attenuator / DDC center
frequency / wideband-filter bypass.  The reference's Python layer holds
the rate table (48k..2M, quisk_hardware.py:40-51), the attenuator steps
(0/-10/-20/-30 dB, :34) and a float VFO (ReturnVfoFloat, :113).

Here the same control plane over an injected ``driver`` object — any
object with ``open_device/close_device/set_attenuator/set_sampling_rate/
set_ddc_center_freq/set_wideband`` (the libperseus-sdr entry points
perseus.c wraps); tests inject a fake, a real deployment passes a ctypes
binding.  Sample delivery arrives through the driver's callback into
``feed_samples`` as interleaved float I/Q, the same shape perseus.c's
user-data callback hands the reference.
"""

from __future__ import annotations

import numpy as np

from quisk_tpu_torch.hw.base import Hardware, register_hardware

ATTEN_DB = (0, -10, -20, -30)      # quisk_hardware.py:34 rf_gain_labels
RATES = (48000, 95000, 96000, 125000, 192000, 250000,
         500000, 1000000, 1600000, 2000000)


@register_hardware("perseus")
class PerseusHardware(Hardware):
    """Perseus over an injected driver double (no libperseus in CI)."""

    def __init__(self, conf=None, driver=None):
        super().__init__(conf)
        self.driver = driver
        self.current_rate = 192000     # quisk_hardware.py:51
        self.att_index = 0
        self.wideband = False          # False = band filter in line
        self.fVFO = 0.0                # float VFO (ReturnVfoFloat)
        self._pending: list[np.ndarray] = []

    def open(self) -> str:
        if self.driver is None:
            return "Perseus module not available"   # quisk_hardware.py:74
        self.status_text = str(self.driver.open_device("perseus", 2, 3))
        self.driver.set_sampling_rate(self.current_rate)
        self.driver.set_attenuator(ATTEN_DB[self.att_index])
        return self.status_text

    def close(self) -> None:
        if self.driver is not None:
            self.driver.close_device(1)

    def set_attenuator_index(self, index: int) -> int:
        """0..3 -> 0/-10/-20/-30 dB (OnButtonRfGain, :92-97)."""
        self.att_index = int(index) % len(ATTEN_DB)
        if self.driver is not None:
            self.driver.set_attenuator(ATTEN_DB[self.att_index])
        return ATTEN_DB[self.att_index]

    def set_wideband(self, enable: bool) -> None:
        """Bypass the preselector ('Wide Band' antenna label, :35)."""
        self.wideband = bool(enable)
        if self.driver is not None:
            self.driver.set_wideband(1 if enable else 0)

    def ChangeFrequency(self, tx_freq, vfo_freq, source="", band=""):
        self.fVFO = float(vfo_freq)
        if self.driver is not None and vfo_freq:
            self.driver.set_ddc_center_freq(self.fVFO)
        return super().ChangeFrequency(tx_freq, vfo_freq, source, band)

    def ReturnVfoFloat(self) -> float:
        return self.fVFO

    def VarDecimGetChoices(self) -> list[int]:
        return list(RATES)

    def VarDecimGetIndex(self) -> int:
        return RATES.index(self.current_rate)

    def VarDecimSet(self, index: int) -> float:
        self.current_rate = RATES[index]
        if self.driver is not None:
            self.driver.set_sampling_rate(self.current_rate)
        return float(self.current_rate)

    # sample plane: the libperseus callback delivers interleaved float I/Q
    def feed_samples(self, interleaved: np.ndarray) -> None:
        iq = np.asarray(interleaved, np.float32).reshape(-1, 2)
        self._pending.append((iq[:, 0] + 1j * iq[:, 1]).astype(np.complex64))

    def read_samples(self, n: int) -> np.ndarray | None:
        have = sum(len(b) for b in self._pending)
        if have < n:
            return None                     # starved: let the caller wait
        buf = np.concatenate(self._pending)
        self._pending = [buf[n:]] if have > n else []
        return buf[None, :n]
