"""AOR AR8600 + SDR-IQ panadapter hardware.

Parity: quisk_hardware_sdr8600.py (71 LoC) — the AR8600's 10.7 MHz IF
output feeds an SDR-IQ; the receiver itself is tuned over a 9600-baud
serial port with AOR text commands, rate-limited to one command per
20 ms with a deferred-send queue drained from HeartBeat:

- 'MD0\\r' on open (WFM mode enables the IF output),
- 'RF%010d\\r' to tune (VFO rounded to 10 kHz steps),
- 'EX\\r' on close,
- spectrum is inverted (QS.invert_spectrum(1)) because the 8600 IF
  inverts 2 m / 70 cm.

The serial transport is injectable (``write(bytes)``/``read(n)``), and
the rate limiter takes a clock function so tests control time.
"""

from __future__ import annotations

import time

from quisk_tpu_torch.hw.base import register_hardware
from quisk_tpu_torch.hw.sdriq import SdriqHardware

IF_FREQ = 10_700_000
COMMAND_SPACING_S = 0.02
STEP_HZ = 10_000


def round_vfo(vfo_freq: float) -> int:
    """AR8600 tunes in 10 kHz steps no matter the display step."""
    return int((int(vfo_freq) + STEP_HZ // 2) // STEP_HZ) * STEP_HZ


@register_hardware("sdr8600")
class Sdr8600Hardware(SdriqHardware):
    """SDR-IQ capture + AR8600 serial tuning with paced commands."""

    def __init__(self, conf=None, transport=None, serial=None, clock=None):
        super().__init__(conf, transport)
        self.serial = serial
        self.clock = clock or time.monotonic
        self.invert_spectrum = True        # QS.invert_spectrum(1) parity
        self.vfo_frequency = 0
        self._time0 = 0.0
        self._pending: list[bytes] = []

    def open(self) -> str:
        if self.serial is not None:
            self.send_ar8600(b"MD0\r")     # WFM mode -> IF output on
        super().open()
        # the panadapter itself sits at the fixed IF center
        super().ChangeFrequency(IF_FREQ, IF_FREQ)
        self.status_text = "AR8600 IF -> SDR-IQ"
        return self.status_text

    def close(self) -> None:
        super().StopSamples()
        if self.serial is not None:
            self.serial.write(b"EX\r")
            self.serial = None

    def ChangeFrequency(self, rx_freq, vfo_freq, source="", band=""):
        vfo = round_vfo(vfo_freq)
        if vfo != self.vfo_frequency and vfo >= 100_000:
            self.vfo_frequency = vfo
            self.send_ar8600(b"RF%010d\r" % vfo)
        return rx_freq, vfo

    def ChangeBand(self, band: str) -> None:
        return                             # defeat base class (reference)

    def send_ar8600(self, msg: bytes) -> None:
        """Send now if the 20 ms spacing allows, else queue for
        HeartBeat (SendAR8600 parity)."""
        if self.serial is None:
            return
        now = self.clock()
        if now - self._time0 > COMMAND_SPACING_S:
            self.serial.write(msg)
            self._time0 = now
        else:
            self._pending.append(msg)

    def HeartBeat(self) -> None:
        if self.serial is None:
            return
        self.serial.read(1024)             # drain radio chatter
        if self._pending and self.clock() - self._time0 > COMMAND_SPACING_S:
            self.serial.write(self._pending.pop(0))
            self._time0 = self.clock()
