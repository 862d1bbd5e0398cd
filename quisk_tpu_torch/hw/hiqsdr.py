"""HiQSDR / N2ADR-2010 control plane.

Parity: hiqsdr/quisk_hardware.py (control protocol documented at its
lines 19-60) and the UDP sample reader quisk.c:3284.  The control channel
is a small UDP packet, resent until the hardware echoes it back:

  bytes [0:2]  'St'
  [2:6]   Rx tune phase (little-endian uint32, phase = freq/clock * 2^32)
  [6:10]  Tx tune phase
  [10]    Tx output level 0-255
  [11]    Tx control bits (CW tx 0x01, other tx 0x02, extended IO 0x04,
          software key-down 0x08, tx rate bits 5:4 — 00=48k 01=192k
          10=480k 11=8k)
  [12]    Rx control: second-stage decimation less one (bits 5:0)
  [13]    firmware version
  [14]    X1 connector: preselect/preamp pins     (firmware >= 1.1)
  [15]    attenuator pins (0x01=2dB 0x02=4dB 0x04=8dB 0x08=10dB 0x10=20dB)
  [16]    antenna switch (0x01)
  [17]    sidetone volume 0-255                   (firmware >= 1.3)
  [18:20] vna_count (little-endian), zero for normal RX
  [20]    CW delay
  [21]    control bits: 0x01 tx mirror on rx (adaptive predistortion)

The sample plane (1442-byte packets: 1-byte seq + key/overrange status +
packed 24-bit I/Q) lives in quisk_tpu_torch.io.native.HiqsdrStream / the C++
qt_hiqsdr_* functions.
"""

from __future__ import annotations

import math
import struct

import numpy as np

from quisk_tpu_torch.hw.base import Hardware, register_hardware

RX_CLOCK = 122_880_000          # ADC clock of the HiQSDR (ref conf rx_udp_clock)


def tune_phase(freq_hz: float, clock_hz: int = RX_CLOCK) -> int:
    """DDS phase word: freq/clock * 2^32, rounded, wrapped to uint32."""
    return int(round(freq_hz / clock_hz * (1 << 32))) & 0xFFFFFFFF


def decimation_for_rate(sample_rate: float,
                        clock_hz: int = RX_CLOCK) -> tuple[int, int]:
    """(prescaler_code, second_stage) for a requested IQ sample rate.

    The FPGA decimates by a prescaler (code 0b00 -> /8 or 0b10 -> /40,
    both 3-byte samples) then a variable 1-40 second stage packed as
    value-1 in rx_control bits 5:0: rate = clock / (prescaler * second)."""
    for code, pre in ((0b00, 8), (0b10, 40)):
        second = clock_hz / (pre * sample_rate)
        s = int(round(second))
        if 1 <= s <= 40 and abs(second - s) < 1e-6:
            return code, s
    raise ValueError(f"rate {sample_rate} not reachable by "
                     f"{clock_hz}/(8|40 x 1..40)")


class HiqsdrControl:
    """Builds the 22-byte control packet from named settings."""

    def __init__(self, clock_hz: int = RX_CLOCK, firmware: int = 3):
        self.clock = clock_hz
        self.firmware = firmware
        self.rx_freq = 7_000_000.0
        self.tx_freq = 7_000_000.0
        self.tx_level = 0
        self.tx_ctrl = 0x02          # enable non-CW transmit
        code, second = decimation_for_rate(192_000.0, clock_hz)
        self.rx_ctrl = (code << 6) | (second - 1)
        self.x1 = 0
        self.attenuator = 0
        self.ant = 0
        self.sidetone = 0
        self.vna_count = 0
        self.cw_delay = 0
        self.misc_ctrl = 0

    def set_rate(self, sample_rate: float) -> None:
        code, second = decimation_for_rate(sample_rate, self.clock)
        self.rx_ctrl = (code << 6) | ((second - 1) & 0x3F)

    def set_key_down(self, down: bool) -> None:
        self.tx_ctrl = (self.tx_ctrl | 0x08) if down else (self.tx_ctrl & ~0x08)

    def set_vna(self, start_hz: float, stop_hz: float, count: int) -> None:
        """VNA scan setup (parity quisk_vna.py:963 SetVNA): rx phase is the
        start frequency, tx phase the per-point increment."""
        self.vna_count = count
        self.rx_freq = start_hz
        self.tx_freq = (stop_hz - start_hz) / max(count - 1, 1)

    def packet(self) -> bytes:
        p = struct.pack("<2sIIBBBB",
                        b"St",
                        tune_phase(self.rx_freq, self.clock),
                        tune_phase(self.tx_freq, self.clock),
                        self.tx_level & 0xFF,
                        self.tx_ctrl & 0xFF,
                        self.rx_ctrl & 0xFF,
                        self.firmware & 0xFF)
        if self.firmware == 0:
            return p
        return p + struct.pack("<BBBBHBB",
                               self.x1 & 0xFF,
                               self.attenuator & 0xFF,
                               self.ant & 0xFF,
                               self.sidetone & 0xFF,
                               self.vna_count & 0xFFFF,
                               self.cw_delay & 0xFF,
                               self.misc_ctrl & 0xFF)


@register_hardware("hiqsdr")
class HiqsdrHardware(Hardware):
    """HiQSDR over UDP: control packets on the control port, samples via
    quisk_tpu_torch.io.native.HiqsdrStream.  A transport object (anything with
    sendto/recv) is injected so tests run without sockets."""

    def __init__(self, conf=None, transport=None, clock_hz: int = RX_CLOCK):
        super().__init__(conf)
        self.ctl = HiqsdrControl(clock_hz)
        self.transport = transport
        self.acked = False
        self.pump = None

    # ---- live sample plane (quisk.c:3284 quisk_read_rx_udp equivalent) ---
    def start_pump(self, port: int = 0, host: str = "127.0.0.1"):
        """Bind the live UDP sample pump; returns (host, port) to stream
        1442-byte HiQSDR packets to."""
        from quisk_tpu_torch.io.pump import make_pump

        # native C++ pump (recvmmsg + parse + ring) when built; Python
        # UdpPump fallback otherwise
        self.pump = make_pump("hiqsdr", n_rx=1, port=port, host=host)
        self.pump.start()
        return self.pump.local_addr

    def read_samples(self, n: int):
        if self.pump is None:
            return None
        return self.pump.read_samples(n)

    def close(self) -> None:
        if self.pump is not None:
            self.pump.stop()
            self.pump = None

    def open(self) -> str:
        self._send_ctl()
        self.status_text = "HiQSDR control started"
        return self.status_text

    def _send_ctl(self) -> None:
        if self.transport is not None:
            self.transport.sendto(self.ctl.packet())
        self.acked = False

    def HeartBeat(self) -> None:
        # resend control packet until the hardware echoes it (ref behavior:
        # got_udp_status compared against want_udp_status)
        if self.transport is None:
            return
        echo = self.transport.poll_ctl()
        if echo is not None and echo[:1] == b"S" and echo[1:] == self.ctl.packet()[1:]:
            self.acked = True
        if not self.acked:
            self.transport.sendto(self.ctl.packet())

    def ChangeFrequency(self, tx_freq, vfo_freq, source="", band=""):
        self.ctl.tx_freq = float(tx_freq)
        self.ctl.rx_freq = float(vfo_freq)
        self._send_ctl()
        return super().ChangeFrequency(tx_freq, vfo_freq, source, band)

    def OnButtonPTT(self, pressed: bool) -> None:
        self.ctl.set_key_down(pressed)
        self._send_ctl()

    def VarDecimGetChoices(self) -> list[int]:
        # rates reachable as clock/(8 * 1..40) or clock/(40 * 1..40)
        return [96000, 192000, 384000, 480000, 960000]

    def VarDecimSet(self, index: int) -> float:
        rate = float(self.VarDecimGetChoices()[index])
        self.ctl.set_rate(rate)
        self._send_ctl()
        return rate

    # ---- VNA (parity quisk_vna.py / SetVNA) -----------------------------
    def SetVNA(self, key_down=None, vna_start=None, vna_stop=None,
               vna_count=None, do_tx=False):
        if vna_count is not None and vna_start is not None and vna_stop is not None:
            self.ctl.set_vna(vna_start, vna_stop, vna_count)
        if key_down is not None:
            self.ctl.set_key_down(key_down)
        self._send_ctl()
        return (self.ctl.rx_freq,
                self.ctl.rx_freq + self.ctl.tx_freq * max(self.ctl.vna_count - 1, 0))
