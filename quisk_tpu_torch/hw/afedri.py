"""AFEDRI SDR-NET control (TCP control items) and UDP sample plane.

Parity: afedrinet/afedri.py (219 LoC, the k3it/4Z5LV control class) and
afedrinet/quisk_hardware.py + afedrinet_io.c.  The AFEDRI speaks the
RFSPACE NetSDR control-item protocol over TCP port 50000 — the same
16-bit little-endian ``length | type<<13`` block headers as the SDR-IQ
serial protocol (quisk_tpu_torch.hw.sdriq reuses for free) — and streams
samples as 1028-byte UDP packets: a NetSDR data header ``04 84``, a
16-bit little-endian sequence number, then 256 16-bit LE I/Q pairs
(afedrinet_io.c:67/235-247).

Control items (afedri.py:58-140):
- 0x0020 center frequency  (channel byte + 5-byte LE Hz)
- 0x00B8 output sample rate (channel byte + 4-byte LE)
- 0x0038 RF gain            (channel byte + encoded gain byte,
  ``((gain_db+10)//3 << 3) | 1``; decode ``-10 + 3*(byte>>3)``)
- 0x0018 receiver state     (0x80 complex, 0x02 run / 0x00, 0x01 stop)
- 0x0001 (request) SDR name
- 0x5502 (hardware type 7) front-end clock, read as two 16-bit words

Discovery uses the AE4JY Simple Network Discovery Protocol: a 56-byte
UDP broadcast (magic ``38 00 5a a5``) to port 48321; the radio answers
on 48322 with name/serial/ip/port (afedri.py:147-186).  The valid
sample rates are quantized by the front-end clock: divider
``clock/(4*rate)`` rounded and clamped to [15, 625] (afedri.py:199-216).
"""

from __future__ import annotations

import socket
import struct

import numpy as np

from quisk_tpu_torch.hw.base import Hardware, register_hardware
from quisk_tpu_torch.hw.sdriq import TYPE_REQUEST, build_control, build_message

ITEM_STATE = 0x0018
ITEM_FREQUENCY = 0x0020
ITEM_GAIN = 0x0038
ITEM_OUT_RATE = 0x00B8
ITEM_NAME = 0x0001
ITEM_FE_CLOCK = 0x5502
TYPE_HARDWARE = 7

DISCOVER_SERVER_PORT = 48321      # radio listens here for the broadcast
DISCOVER_CLIENT_PORT = 48322      # radio answers here
DISCOVER_MAGIC = b"\x38\x00\x5a\xa5"

RX_UDP_SIZE = 1028                # afedrinet_io.c:67
DATA_HEADER = b"\x04\x84"         # NetSDR large-data-block header


# ---- control-item builders (TCP) ----------------------------------------
def set_center_freq(freq_hz: int, channel: int = 0) -> bytes:
    return build_control(ITEM_FREQUENCY,
                         bytes([channel])
                         + struct.pack("<q", int(round(freq_hz)))[:5])


def set_sample_rate(rate_hz: int, channel: int = 0) -> bytes:
    return build_control(ITEM_OUT_RATE,
                         bytes([channel]) + struct.pack("<I", int(rate_hz)))


def encode_gain(gain_db: float) -> int:
    """AFEDRI gain byte: index = (gain+10)/3, packed ``index<<3 | 1``."""
    return ((int(gain_db) + 10) // 3 << 3) + 1


def decode_gain(byte: int) -> int:
    return -10 + 3 * (byte >> 3)


def set_gain(gain_db: float, channel: int = 0) -> bytes:
    return build_control(ITEM_GAIN, bytes([channel, encode_gain(gain_db)]))


def set_state(run: bool) -> bytes:
    if run:            # 16-bit complex contiguous capture
        return build_control(ITEM_STATE, bytes([0x80, 0x02, 0x00, 0x00]))
    return build_control(ITEM_STATE, bytes([0x00, 0x01, 0x00, 0x00]))


def request_name() -> bytes:
    return build_message(TYPE_REQUEST, struct.pack("<H", ITEM_NAME))


def request_fe_clock_word(word: int) -> bytes:
    """Read half of the 32-bit front-end clock (word 0 = low, 1 = high)."""
    return build_message(TYPE_HARDWARE,
                         struct.pack("<HB", ITEM_FE_CLOCK, word)
                         + b"\x00\x00\x00\x00")


def parse_fe_clock(low_resp: bytes, high_resp: bytes) -> int:
    """Combine the two 9-byte responses; the 16-bit word sits at [4:6]."""
    lo = struct.unpack_from("<H", low_resp, 4)[0]
    hi = struct.unpack_from("<H", high_resp, 4)[0]
    return lo | (hi << 16)


def valid_sample_rate(rate_hz: int, fe_clock_hz: int = 80_000_000) -> int:
    """Snap a requested rate to the nearest achievable one.

    The hardware divides the front-end clock by 4*div with div in
    [15, 625] (afedri.py:199-216, the 4z5lv verification snippet)."""
    div = int(round(fe_clock_hz / (4.0 * rate_hz)))
    div = min(625, max(15, div))
    return int(round(fe_clock_hz / (4.0 * div)))


# ---- discovery (AE4JY SNDP) ----------------------------------------------
def build_discovery() -> bytes:
    return DISCOVER_MAGIC.ljust(56, b"\x00")


def parse_discovery_reply(msg: bytes) -> tuple[str, str, str, int]:
    """(device name, serial, ip, port) from the 56+-byte reply."""
    name = msg[5:20].split(b"\x00")[0].decode("utf-8", "replace")
    serial = msg[21:36].split(b"\x00")[0].decode("utf-8", "replace")
    ip = socket.inet_ntoa(msg[40:36:-1])
    port = struct.unpack_from("<H", msg, 53)[0]
    return name, serial, ip, port


# ---- UDP sample plane ------------------------------------------------------
def parse_udp_packet(pkt: bytes) -> tuple[int, np.ndarray] | None:
    """(sequence, complex64[256]) from one 1028-byte data packet."""
    if len(pkt) != RX_UDP_SIZE or pkt[:2] != DATA_HEADER:
        return None
    seq = struct.unpack_from("<H", pkt, 2)[0]
    iq = np.frombuffer(pkt, "<i2", offset=4).astype(np.float32).reshape(-1, 2)
    return seq, ((iq[:, 0] + 1j * iq[:, 1]) / 32768.0).astype(np.complex64)


def build_udp_packet(seq: int, iq: np.ndarray) -> bytes:
    """Inverse of parse_udp_packet, for loopback tests."""
    s = np.round(np.clip(
        np.stack([iq.real, iq.imag], -1) * 32768.0, -32768, 32767)
    ).astype("<i2")
    return DATA_HEADER + struct.pack("<H", seq & 0xFFFF) + s.tobytes()


@register_hardware("afedri")
class AfedriHardware(Hardware):
    """AFEDRI SDR-NET over an injected control transport (write()/recv()).

    RATES mirrors afedrinet/quisk_hardware.py:36-38; each is re-snapped to
    the measured front-end clock when available."""

    RATES = (53333, 96000, 133333, 185185, 192000, 370370, 740740, 1333333)

    def __init__(self, conf=None, transport=None,
                 fe_clock: int = 80_000_000, gain_db: float = -10.0):
        super().__init__(conf)
        self.transport = transport
        self.fe_clock = fe_clock
        self.gain_db = gain_db
        self.index = 4                 # 192000, the reference default
        self._pending: list[np.ndarray] = []
        self._next_seq: int | None = None
        self.seq_errors = 0

    def _w(self, msg: bytes) -> None:
        if self.transport is not None:
            self.transport.write(msg)

    def open(self) -> str:
        self._w(set_gain(self.gain_db))
        self.status_text = "AFEDRI SDR-NET"
        return self.status_text

    def StartSamples(self) -> None:
        self._w(set_sample_rate(self.RATES[self.index]))
        self._w(set_state(True))

    def StopSamples(self) -> None:
        self._w(set_state(False))

    def ChangeFrequency(self, tx_freq, vfo_freq, source="", band=""):
        if vfo_freq:
            self._w(set_center_freq(vfo_freq))
        return super().ChangeFrequency(tx_freq, vfo_freq, source, band)

    def VarDecimGetChoices(self) -> list[int]:
        return [valid_sample_rate(r, self.fe_clock) for r in self.RATES]

    def VarDecimGetIndex(self) -> int:
        return self.index

    def VarDecimSet(self, index: int) -> float:
        self.index = index
        rate = valid_sample_rate(self.RATES[index], self.fe_clock)
        self._w(set_sample_rate(rate))
        return float(rate)

    # sample plane: feed raw UDP payloads (from quisk_tpu_torch.io.pump or tests)
    def feed_udp(self, pkt: bytes) -> None:
        parsed = parse_udp_packet(pkt)
        if parsed is None:
            return
        seq, iq = parsed
        if self._next_seq is not None and seq != self._next_seq:
            self.seq_errors += 1
        self._next_seq = (seq + 1) & 0xFFFF
        self._pending.append(iq)

    def read_samples(self, n: int) -> np.ndarray | None:
        have = sum(len(b) for b in self._pending)
        if have < n:
            return None                     # starved: let the caller wait
        buf = np.concatenate(self._pending)
        self._pending = [buf[n:]] if have > n else []
        return buf[None, :n]
