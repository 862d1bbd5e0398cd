"""RFSPACE SDR-IQ serial-framed control/data protocol.

Parity: quisk_hardware_sdriq.py (491 LoC) — the SDR-IQ talks over a USB
serial port with 16-bit little-endian block headers: bits 12:0 length
(including the header), bits 15:13 message type.  Control items carry a
2-byte little-endian item code; ADC data arrives as type-4 blocks of
8192 bytes of 16-bit I/Q.

Message types: 0 = set control item (host->radio), 1 = request item,
3 = ack/response, 4 = data item 0.  Control items used here:
0x0018 receiver state (run/stop), 0x0020 center frequency (5-byte:
4-byte LE Hz + channel), 0x00B0 A/D input sample rate, 0xB8 output rate.
"""

from __future__ import annotations

import struct

import numpy as np

from quisk_tpu_torch.hw.base import Hardware, register_hardware

TYPE_SET = 0
TYPE_REQUEST = 1
TYPE_RESPONSE = 3
TYPE_DATA0 = 4

ITEM_STATE = 0x0018
ITEM_FREQUENCY = 0x0020
ITEM_AD_RATE = 0x00B0
ITEM_OUT_RATE = 0x00B8

STATE_RUN = 0x02
STATE_STOP = 0x01


def build_message(msg_type: int, payload: bytes) -> bytes:
    n = len(payload) + 2
    if n >= (1 << 13):
        raise ValueError("message too long")
    return struct.pack("<H", n | (msg_type << 13)) + payload


def build_control(item: int, data: bytes) -> bytes:
    return build_message(TYPE_SET, struct.pack("<H", item) + data)


def set_frequency(freq_hz: float, channel: int = 0) -> bytes:
    return build_control(ITEM_FREQUENCY,
                         bytes([channel])
                         + struct.pack("<I", int(round(freq_hz))) + b"\x00")


def set_state(run: bool) -> bytes:
    # channel 0x81 = complex I/Q capture, mode 0 continuous
    return build_control(ITEM_STATE,
                         bytes([0x81, STATE_RUN if run else STATE_STOP,
                                0x00, 0x00]))


def set_output_rate(rate_hz: int, channel: int = 0) -> bytes:
    return build_control(ITEM_OUT_RATE,
                         bytes([channel]) + struct.pack("<I", rate_hz))


class SdriqFramer:
    """Incremental parser for the serial byte stream -> messages.

    Data blocks (type 4, length field 0 means the full 8194-byte block)
    are converted to complex64; control responses returned as
    (item, payload).
    """

    DATA_BLOCK = 8192              # bytes of samples in a data message

    def __init__(self):
        self.buf = b""
        self.samples: list[np.ndarray] = []
        self.responses: list[tuple[int, bytes]] = []

    def feed(self, data: bytes) -> None:
        self.buf += data
        while len(self.buf) >= 2:
            hdr = struct.unpack_from("<H", self.buf)[0]
            msg_type = hdr >> 13
            length = hdr & 0x1FFF
            if msg_type == TYPE_DATA0 and length == 0:
                length = self.DATA_BLOCK + 2       # large data block
            if length < 2 or len(self.buf) < length:
                return
            payload = self.buf[2:length]
            self.buf = self.buf[length:]
            if msg_type == TYPE_DATA0:
                iq = np.frombuffer(payload, "<i2").astype(np.float32)
                iq = iq.reshape(-1, 2)
                self.samples.append(
                    ((iq[:, 0] + 1j * iq[:, 1]) / 32768.0)
                    .astype(np.complex64))
            elif msg_type == TYPE_RESPONSE and len(payload) >= 2:
                item = struct.unpack_from("<H", payload)[0]
                self.responses.append((item, payload[2:]))

    def take_samples(self) -> np.ndarray:
        if not self.samples:
            return np.zeros(0, np.complex64)
        out = np.concatenate(self.samples)
        self.samples.clear()
        return out


@register_hardware("sdriq")
class SdriqHardware(Hardware):
    """SDR-IQ over an injected serial transport (anything with write())."""

    RATES = (8138, 16276, 37793, 55556, 111111, 158730, 196078)

    def __init__(self, conf=None, transport=None):
        super().__init__(conf)
        self.transport = transport
        self.framer = SdriqFramer()
        self.rate = 196078

    def open(self) -> str:
        self.status_text = "SDR-IQ"
        return self.status_text

    def _w(self, msg: bytes) -> None:
        if self.transport is not None:
            self.transport.write(msg)

    def StartSamples(self) -> None:
        self._w(set_output_rate(self.rate))
        self._w(set_state(True))

    def StopSamples(self) -> None:
        self._w(set_state(False))

    def ChangeFrequency(self, tx_freq, vfo_freq, source="", band=""):
        self._w(set_frequency(vfo_freq))
        return super().ChangeFrequency(tx_freq, vfo_freq, source, band)

    def VarDecimGetChoices(self) -> list[int]:
        return list(self.RATES)

    def VarDecimSet(self, index: int) -> float:
        self.rate = self.RATES[index]
        self._w(set_output_rate(self.rate))
        return float(self.rate)

    def read_samples(self, n: int) -> np.ndarray | None:
        got = self.framer.take_samples()
        return got[None] if len(got) else None
