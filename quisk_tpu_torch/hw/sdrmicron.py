"""SDR-Micron (Dfinitski) FTDI sync-FIFO protocol.

Parity: sdrmicronpkg/quisk_hardware.py (266 LoC) — the SDR Micron talks
over an FT2232H synchronous FIFO with fixed 32-byte control messages and
508-byte data frames, both starting with the preamble 7*0x55, 0xD5:

- RX control:  preamble + 'RX0' + enable + rate + 4-byte MSB-first
  frequency + attenuation + 14 zeros (rx_control_upd).
- Bandscope control: preamble + 'BS0' + enable + period_ms + 19 zeros.
- RX data frame: preamble + 'RX0' + FW1 + FW2 + CLIP + 2 zeros + 492
  bytes of I/Q — 82 pairs of 24-bit MSB-first below 960 ksps, 123 pairs
  of 16-bit MSB-first at 960 ksps and above.
- Bandscope frame: preamble + 'BS0' + FW1 + FW2 + CLIP + PN + 0 + 492
  data bytes; packets PN=0..65 carry 492 bytes each and PN=66 the final
  296 bytes of a 16384-sample 16-bit MSB-first ADC block.

The FTDI transport is injectable (tests run without hardware): anything
with ``write(bytes)``; inbound bytes are pushed into :class:`MicronFramer`.
"""

from __future__ import annotations

import numpy as np

from quisk_tpu_torch.hw.base import Hardware, register_hardware

PREAMBLE = b"\x55" * 7 + b"\xd5"
FRAME_LEN = 508
CTRL_LEN = 32
DATA_BYTES = 492
BSCOPE_SIZE = 16384            # 16-bit samples per assembled bandscope block
BSCOPE_LAST_PN = 66
BSCOPE_LAST_BYTES = 296

#: index -> input sample rate in Hz (sdrmicronpkg rate table)
SAMPLE_RATES = (48000, 96000, 192000, 240000, 384000, 480000, 640000,
                768000, 960000, 1536000, 1920000)
ADC_CLOCK = 76_800_000         # sdrmicron_clock


def build_rx_control(enable: bool, rate_index: int, freq_hz: int,
                     att_db: int) -> bytes:
    """32-byte RX0 control message (rx_control_upd parity)."""
    if att_db not in (0, 10, 20, 30):
        raise ValueError("attenuation must be 0/10/20/30 dB")
    if not 0 <= rate_index < len(SAMPLE_RATES):
        raise ValueError("bad rate index")
    f = int(freq_hz) & 0xFFFFFFFF
    msg = PREAMBLE + b"RX0" + bytes((
        1 if enable else 0, rate_index,
        (f >> 24) & 0xFF, (f >> 16) & 0xFF, (f >> 8) & 0xFF, f & 0xFF,
        att_db)) + bytes(14)
    assert len(msg) == CTRL_LEN
    return msg


def build_bscope_control(enable: bool, period_ms: int = 100) -> bytes:
    """32-byte BS0 control message (bscope_control_upd parity)."""
    if not 50 <= period_ms <= 255:
        raise ValueError("bandscope period must be 50..255 ms")
    msg = PREAMBLE + b"BS0" + bytes((1 if enable else 0, period_ms)) \
        + bytes(19)
    assert len(msg) == CTRL_LEN
    return msg


def unpack_iq24_be(data: bytes | np.ndarray) -> np.ndarray:
    """MSB-first 24-bit I/Q pairs ('I2 I1 I0 Q2 Q1 Q0') -> complex64,
    scaled to +-1."""
    b = np.frombuffer(bytes(data), np.uint8)
    b = b[: (len(b) // 6) * 6].reshape(-1, 6).astype(np.int32)
    words = (b[:, ::3] << 16) | (b[:, 1::3] << 8) | b[:, 2::3]
    words = np.where(words >= 1 << 23, words - (1 << 24), words)
    return ((words[:, 0] + 1j * words[:, 1]) / float(1 << 23)) \
        .astype(np.complex64)


def unpack_iq16_be(data: bytes | np.ndarray) -> np.ndarray:
    """MSB-first 16-bit I/Q pairs -> complex64, scaled to +-1."""
    w = np.frombuffer(bytes(data), ">i2")
    w = w[: (len(w) // 2) * 2].reshape(-1, 2).astype(np.float32)
    return ((w[:, 0] + 1j * w[:, 1]) / 32768.0).astype(np.complex64)


class MicronFramer:
    """Incremental 508-byte frame parser (GetRxSamples parity).

    Collects RX I/Q samples, assembles 67-packet bandscope blocks, and
    tracks firmware version / ADC clip counts."""

    def __init__(self, wide: bool = False):
        self.wide = wide            # True at >=960 ksps: 16-bit samples
        self.buf = b""
        self.samples: list[np.ndarray] = []
        self.bscope_frames: list[np.ndarray] = []
        self._bscope_accum = bytearray()
        self.fw_version: str | None = None
        self.clip_count = 0
        self.resync_count = 0

    def feed(self, data: bytes) -> None:
        self.buf += data
        while len(self.buf) >= FRAME_LEN:
            if self.buf[:8] != PREAMBLE:
                # hunt for the preamble (lost sync)
                idx = self.buf.find(PREAMBLE, 1)
                self.resync_count += 1
                if idx < 0:
                    self.buf = self.buf[-7:]
                    return
                self.buf = self.buf[idx:]
                continue
            frame, self.buf = self.buf[:FRAME_LEN], self.buf[FRAME_LEN:]
            kind = frame[8:11]
            if self.fw_version is None:
                self.fw_version = chr(frame[11]) + "." + chr(frame[12])
            if frame[13]:
                self.clip_count += 1
            if kind == b"RX0":
                raw = frame[16:16 + DATA_BYTES]
                self.samples.append(unpack_iq16_be(raw) if self.wide
                                    else unpack_iq24_be(raw))
            elif kind == b"BS0":
                self._feed_bscope(frame)

    def _feed_bscope(self, frame: bytes) -> None:
        pn = frame[14]
        if pn == 0:
            self._bscope_accum = bytearray(frame[16:16 + DATA_BYTES])
        elif pn < BSCOPE_LAST_PN:
            self._bscope_accum += frame[16:16 + DATA_BYTES]
        else:                       # final packet: 296 real bytes + junk
            self._bscope_accum += frame[16:16 + BSCOPE_LAST_BYTES]
            if len(self._bscope_accum) == BSCOPE_SIZE * 2:
                adc = (np.frombuffer(bytes(self._bscope_accum), ">i2")
                       .astype(np.float32) / 32768.0)
                self.bscope_frames.append(adc)
            self._bscope_accum = bytearray()

    def take_samples(self) -> np.ndarray:
        if not self.samples:
            return np.zeros(0, np.complex64)
        out = np.concatenate(self.samples)
        self.samples.clear()
        return out

    def take_bscope(self) -> np.ndarray | None:
        return self.bscope_frames.pop(0) if self.bscope_frames else None


def pack_rx_frame(iq: np.ndarray, fw=(ord("1"), ord("0")),
                  clip: bool = False, wide: bool = False) -> bytes:
    """Device-side RX0 frame builder (for loopback tests and the VNA-style
    simulator): inverse of MicronFramer's RX path."""
    if wide:
        w = np.clip(np.round(
            np.stack([iq.real, iq.imag], -1).reshape(-1) * 32768.0),
            -32768, 32767).astype(">i2")
        raw = w.tobytes()
    else:
        w = np.clip(np.round(
            np.stack([iq.real, iq.imag], -1).reshape(-1) * float(1 << 23)),
            -(1 << 23), (1 << 23) - 1).astype(np.int64)
        w = (w & 0xFFFFFF).astype(np.uint32)
        b = np.empty((len(w), 3), np.uint8)
        b[:, 0] = w >> 16
        b[:, 1] = (w >> 8) & 0xFF
        b[:, 2] = w & 0xFF
        raw = b.tobytes()
    raw = raw[:DATA_BYTES].ljust(DATA_BYTES, b"\0")
    return PREAMBLE + b"RX0" + bytes((fw[0], fw[1], 1 if clip else 0, 0,
                                      0)) + raw


@register_hardware("sdrmicron")
class SdrMicronHardware(Hardware):
    """SDR-Micron over an injected FTDI-like transport (``write(bytes)``).

    Band-dependent attenuation follows the reference's ChangeBand RF-gain
    presets (sdrmicronpkg/quisk_hardware.py ChangeBand)."""

    def __init__(self, conf=None, transport=None):
        super().__init__(conf)
        self.transport = transport
        self.index = 1                     # 96 ksps default (reference)
        self.att = 10
        self.freq = 7_220_000
        self.enable = False
        self.bscope_enable = False
        self.framer = MicronFramer(wide=self._wide())
        self._rxbuf = np.zeros(0, np.complex64)

    # -- wire helpers -----------------------------------------------------
    def _wide(self) -> bool:
        return SAMPLE_RATES[self.index] >= 960000

    def _w(self, msg: bytes) -> None:
        if self.transport is not None:
            self.transport.write(msg)

    def _update(self) -> None:
        self._w(build_rx_control(self.enable, self.index, self.freq,
                                 self.att))

    def open(self) -> str:
        self.status_text = "SDR-Micron"
        return self.status_text

    def close(self) -> None:
        self.enable = False
        self.bscope_enable = False
        self._update()
        self._w(build_bscope_control(False))

    # -- control ----------------------------------------------------------
    def ChangeFrequency(self, tx_freq, vfo_freq, source="", band=""):
        if vfo_freq and vfo_freq != self.freq:
            self.freq = int(vfo_freq)
            self._update()
        return super().ChangeFrequency(tx_freq, vfo_freq, source, band)

    def ChangeBand(self, band: str) -> None:
        super().ChangeBand(band)
        if band in ("160", "80", "60", "40"):
            self.set_attenuation(10)       # 'RF -10'
        elif band in ("20",):
            self.set_attenuation(0)        # 'RF 0'
        # else: preamp ('RF +10') has no attenuator step here

    def set_attenuation(self, att_db: int) -> None:
        self.att = att_db
        self._update()

    def StartSamples(self) -> None:
        self.enable = True
        self.bscope_enable = True
        self._update()
        self._w(build_bscope_control(True))

    def StopSamples(self) -> None:
        self.enable = False
        self.bscope_enable = False
        self._update()
        self._w(build_bscope_control(False))

    # -- variable decimation ----------------------------------------------
    def VarDecimGetChoices(self) -> list[int]:
        return list(SAMPLE_RATES)

    def VarDecimGetIndex(self) -> int:
        return self.index

    def VarDecimSet(self, index: int) -> float:
        self.index = index
        self.framer.wide = self._wide()
        self._update()
        return float(SAMPLE_RATES[index])

    # -- sample plane -----------------------------------------------------
    def feed(self, data: bytes) -> None:
        self.framer.feed(data)

    def read_samples(self, n: int) -> np.ndarray | None:
        """Exactly ``n`` samples as [1, n], or None until enough arrived
        (the Hardware contract Radio.run_once's fixed-shape jitted step
        depends on: frames are 82/123 samples, blocks are thousands)."""
        got = self.framer.take_samples()
        if len(got):
            self._rxbuf = (np.concatenate([self._rxbuf, got])
                           if len(self._rxbuf) else got)
        if len(self._rxbuf) < n:
            return None
        out, self._rxbuf = self._rxbuf[:n], self._rxbuf[n:]
        return out[None]
