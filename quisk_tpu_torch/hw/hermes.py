"""Hermes / Metis (OpenHPSDR protocol 1) control plane.

Parity: hermes/quisk_hardware.py and the C-side register block
(quisk.c:299 ``pc_to_hermes``, sample reader quisk.c:3519).  Control is
carried inside the TX sample stream: every 512-byte USB-style frame has a
5-byte control group C0..C4; C0 bits 7:1 select one of 17 register rows
sent round-robin.  Discovery and start/stop are dedicated UDP packets:

  discovery:  0xEF 0xFE 0x02 + 60 zero bytes (broadcast)
  reply:      0xEF 0xFE 0x02/0x03 + MAC + firmware version + board id
  start/stop: 0xEF 0xFE 0x04 + flags (0x01 IQ, 0x02 bandscope) + 60 zeros

Register rows used here (C0 index -> C1..C4 meaning, MSB first):
  0:  C1[1:0] sample rate (00=48k 01=96k 10=192k 11=384k),
      C3 preamp/dither/random + antenna bits, C4[5:3] n_receivers-1,
      C4[2] duplex
  1:  Tx NCO frequency, Hz
  2:  Rx1 NCO frequency (3..8: Rx2..Rx7)
  9:  C1 Tx drive level
  10: C4[4:0] Rx LNA/attenuator setting
"""

from __future__ import annotations

import struct
import time

import numpy as np

from quisk_tpu_torch.hw.base import Hardware, register_hardware

N_CTL_ROWS = 17


class HermesControl:
    """The 17x4 register block + framing of discovery/start/stop packets."""

    RATES = {48000: 0, 96000: 1, 192000: 2, 384000: 3}

    def __init__(self):
        self.regs = np.zeros((N_CTL_ROWS, 4), np.uint8)
        self.n_rx = 1
        self.duplex = True
        self._sync_row0()

    # ---- row helpers ----------------------------------------------------
    def _sync_row0(self) -> None:
        self.regs[0, 3] = ((self.n_rx - 1) & 0x7) << 3 | (0x4 if self.duplex else 0)

    def set_rate(self, rate: int) -> None:
        self.regs[0, 0] = (int(self.regs[0, 0]) & 0xFC) | self.RATES[int(rate)]

    def set_n_receivers(self, n: int) -> None:
        if not 1 <= n <= 8:
            raise ValueError("1..8 receivers")
        self.n_rx = n
        self._sync_row0()

    def _set_freq(self, row: int, freq_hz: float) -> None:
        f = int(round(freq_hz)) & 0xFFFFFFFF
        self.regs[row] = [(f >> 24) & 0xFF, (f >> 16) & 0xFF,
                          (f >> 8) & 0xFF, f & 0xFF]

    def set_tx_freq(self, freq_hz: float) -> None:
        self._set_freq(1, freq_hz)

    def set_rx_freq(self, rx: int, freq_hz: float) -> None:
        """rx = 0-based receiver index (row 2 is Rx1)."""
        self._set_freq(2 + rx, freq_hz)

    def set_tx_level(self, level: int) -> None:
        self.regs[9, 0] = level & 0xFF

    def set_rx_gain(self, db: int) -> None:
        self.regs[10, 3] = db & 0x1F

    # ---- control-byte access (parity Get/SetControlByte/Bit) ------------
    def get_byte(self, c0_index: int, byte_index: int) -> int:
        """byte_index 1..4 selects C1..C4 (matches the reference API)."""
        return int(self.regs[c0_index, byte_index - 1])

    def set_byte(self, c0_index: int, byte_index: int, value: int) -> None:
        self.regs[c0_index, byte_index - 1] = value & 0xFF

    def set_bit(self, c0_index: int, bit: int, value: bool) -> None:
        byte_index = 4 - bit // 8
        mask = 1 << (bit % 8)
        v = self.get_byte(c0_index, byte_index)
        self.set_byte(c0_index, byte_index,
                      (v | mask) if value else (v & ~mask))

    # ---- round-robin control groups ------------------------------------
    def ctl_group(self, row: int, mox: bool = False) -> bytes:
        """C0..C4 for one 512-byte frame: C0 = row<<1 | MOX."""
        c0 = ((row & 0x7F) << 1) | (1 if mox else 0)
        return bytes([c0]) + self.regs[row].tobytes()

    def ctl_sequence(self, n: int, start_row: int = 0,
                     mox: bool = False) -> list[bytes]:
        return [self.ctl_group((start_row + i) % N_CTL_ROWS, mox)
                for i in range(n)]

    # ---- dedicated UDP packets -----------------------------------------
    @staticmethod
    def discovery_packet() -> bytes:
        return b"\xEF\xFE\x02" + b"\x00" * 60

    @staticmethod
    def parse_discovery_reply(pkt: bytes):
        """-> dict(mac, version, board) or None."""
        if len(pkt) < 11 or pkt[:2] != b"\xEF\xFE" or pkt[2] not in (2, 3):
            return None
        return {"mac": pkt[3:9].hex(":"), "version": pkt[9], "board": pkt[10]}

    @staticmethod
    def start_packet(iq: bool = True, bandscope: bool = False) -> bytes:
        flags = (0x01 if iq else 0) | (0x02 if bandscope else 0)
        return b"\xEF\xFE\x04" + bytes([flags]) + b"\x00" * 60

    @staticmethod
    def stop_packet() -> bytes:
        return b"\xEF\xFE\x04\x00" + b"\x00" * 60


class HermesStartSequencer:
    """The startup/restart handshake (quisk_hermes_is_ready,
    quisk.c:3425-3518): send Stop twice, drain stale packets, prime the
    TX framer, send the receiver-count control frames, then repeat the
    Start packet until sample frames actually flow.  ``step()`` is called
    once per loop iteration (the reference calls it from the sound
    thread) and returns True once we are ready to receive.

    States mirror the reference: 0/1 stop, 2 drain, 3 prime, 4-7 control
    frames, 8 start-until-flowing, 9 running; 20-23 is the temporary-
    shutdown variant (resume() re-enters at 3)."""

    def __init__(self, send, drain=None, send_ctl=None, prime=None,
                 started=None, bandscope: bool = False,
                 min_interval: float = 0.002, clock=time.monotonic):
        self._send = send                  # fn(bytes) -> None (UDP ctl)
        self._drain = drain or (lambda: None)
        self._send_ctl = send_ctl or (lambda: None)
        self._prime = prime or (lambda: None)
        self._started = started or (lambda: False)
        self.bandscope = bandscope
        self.state = 0
        self.start_retries = 0             # state-8 resends (StatusBoard)
        self.restarts = 0
        self._clock = clock
        self._min_interval = min_interval
        self._last = 0.0

    def restart(self) -> None:
        self.state = 0
        self.restarts += 1

    def shutdown(self) -> None:
        """Temporary shutdown (e.g. changing the receiver count)."""
        self.state = 20

    def resume(self) -> None:
        if self.state == 23:
            self.state = 3

    @property
    def running(self) -> bool:
        return self.state == 9

    def step(self) -> bool:
        now = self._clock()
        if now - self._last < self._min_interval and self.state not in (9, 23):
            return self.state in (8, 9)
        self._last = now
        s = self.state
        if s in (0, 20, 1, 21):            # send Stop (twice)
            self._send(HermesControl.stop_packet())
            self.state = s + 1
            return False
        if s in (2, 22):                   # throw away pending records
            self._drain()
            self.state = s + 1
            return False
        if s == 3:                         # prime the TX framer/buffers
            self._prime()
            self.state = 4
            return False
        if s in (4, 5, 6, 7):              # receiver-count control frames
            self._send_ctl()
            self.state = s + 1
            return False
        if s == 8:
            if self._started():
                self.state = 9
            else:
                # keep sending our return address until frames flow
                self._send(HermesControl.start_packet(
                    iq=True, bandscope=self.bandscope))
                self.start_retries += 1
            return True                    # ready to receive (ref: case 8)
        if s == 23:
            return False                   # parked in temporary shutdown
        return True                        # 9: running


class Hl2WriteQueue:
    """HermesLite2 one-time ACK-gated register writes (quisk.c:215-216
    writequeue/writepointer, 3643-3663 ACK routing; microphone.c:894-903
    20 ms resend; hermes/quisk_hardware.py:894-916 50-try timeout).

    ``write()`` queues a 5-byte (addr, d1..d4) register write whose addr
    has the ACK-request bit set; ``poll_tx(mox)`` returns the C0..C4
    group to embed in the next TX frame when a (re)send is due; the
    radio's ACK response routes back through ``on_ack``."""

    RESEND_S = 0.020
    TIMEOUT_TRIES = 50

    def __init__(self, clock=time.monotonic):
        self._clock = clock
        self.queue: bytes | None = None
        self.pending = False
        self._last_send: float | None = None   # None = send immediately
        self.tries = 0
        self.completed = 0
        self.resent = 0                   # radio said "send again" (0x7f)
        self.timeouts = 0
        self.errors_nonmatching = 0
        self.errors_unexpected = 0        # ACK with nothing outstanding

    @property
    def busy(self) -> bool:
        return self.pending

    def write(self, five: bytes) -> None:
        if len(five) != 5:
            raise ValueError("write queue takes exactly 5 bytes")
        self.queue = bytes(five)
        self.pending = True
        self.tries = 0
        self._last_send = None            # send at the next poll_tx

    def poll_tx(self, mox: bool = False) -> bytes | None:
        """C0..C4 for the next TX frame when a (re)send is due.  C0 =
        addr<<1 | MOX (microphone.c:899)."""
        if not self.pending:
            return None
        now = self._clock()
        if self._last_send is not None and now - self._last_send < self.RESEND_S:
            return None
        if self.tries >= self.TIMEOUT_TRIES:
            self.timeouts += 1            # reference clears after 50 tries
            self.pending = False
            return None
        self._last_send = now
        self.tries += 1
        q = self.queue
        return bytes([(q[0] << 1) & 0xFF | (1 if mox else 0)]) + q[1:]

    def on_ack(self, ack5: bytes) -> None:
        """Route an ACK-bearing C0..C4 response (quisk.c:3643-3663)."""
        d = ack5[0] >> 1
        if not self.pending:
            self.errors_unexpected += 1
            return
        if d == 0x7F:                     # radio did not process: resend
            self.resent += 1
            self._last_send = None
        elif d != self.queue[0]:
            self.errors_nonmatching += 1
        else:
            self.pending = False
            self.completed += 1

    def stats(self) -> dict:
        return {"pending": self.pending, "tries": self.tries,
                "completed": self.completed, "resent": self.resent,
                "timeouts": self.timeouts,
                "errors_nonmatching": self.errors_nonmatching,
                "errors_unexpected": self.errors_unexpected}


class Hl2TxBufMonitor:
    """HermesLite2 TX-buffer fault state machine (quisk.c:152-153
    hl2_txbuf_state/hl2_txbuf_errors, 3696-3718): while MOX is held, row
    0's C3 reports the HL2 TX FIFO depth; 0x80/0xFF mean under/overflow.
    Counts transitions into the fault state."""

    def __init__(self):
        self.state = 0
        self.errors = 0

    def step(self, mox: bool, c3: int) -> None:
        if not mox:
            self.state = 0
            return
        if self.state == 0:               # mox just went high
            self.state = 1
        elif self.state == 1:             # wait for first samples buffered
            if c3 & 0x7F:
                self.state = 2
        elif self.state == 2:             # buffering: watch for faults
            if c3 in (0x80, 0xFF):
                self.errors += 1
                self.state = 3
        elif self.state == 3:             # fault: wait for the bit to clear
            if not (c3 & 0x80):
                self.state = 2


@register_hardware("hermes")
class HermesHardware(Hardware):
    """Hermes radio: discovery, start/stop, register round-robin.  The
    sample plane (1032-byte frames, interleaved per-receiver 24-bit I/Q)
    is quisk_tpu_torch.io.native.MetisStream / qt_metis_parse."""

    def __init__(self, conf=None, transport=None):
        super().__init__(conf)
        self.ctl = HermesControl()
        self.transport = transport
        self.board = None
        self._row = 0
        self.pump = None
        self.mox = False
        self.hl2_queue = Hl2WriteQueue()
        self.txbuf = Hl2TxBufMonitor()
        self.start_seq: HermesStartSequencer | None = None

    # ---- live sample plane (quisk.c:3519 read_rx_udp10 equivalent) -------
    def start_pump(self, port: int = 0, host: str = "127.0.0.1"):
        """Bind the live UDP sample pump; returns (host, port) the radio
        (or a test sender) should stream 1032-byte Metis frames to."""
        from quisk_tpu_torch.io.pump import make_pump

        # native C++ pump (recvmmsg + parse + ring) when built; Python
        # UdpPump fallback otherwise
        self.pump = make_pump("metis", n_rx=self.ctl.n_rx, port=port,
                              host=host)
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
        if self.transport is not None:
            self.transport.sendto(self.ctl.discovery_packet())
            reply = self.transport.poll_ctl()
            if reply is not None:
                self.board = HermesControl.parse_discovery_reply(reply)
        self.status_text = f"Hermes {self.board}" if self.board else "Hermes (no reply)"
        return self.status_text

    def StartSamples(self) -> None:
        """Begin (or restart) the ready handshake: unlike a single Start
        packet, the sequencer retries until the radio actually streams
        (quisk_hermes_is_ready, quisk.c:3425-3518).  Without a transport
        this is a no-op (file/test feeds)."""
        if self.transport is None:
            return
        if self.start_seq is None:
            self.start_seq = HermesStartSequencer(
                send=self.transport.sendto,
                drain=self._drain_ctl,
                send_ctl=self._send_ctl_frame,
                started=self._frames_flowing)
        else:
            self.start_seq.restart()
        self.is_ready()

    def StopSamples(self) -> None:
        if self.start_seq is not None:
            self.start_seq.shutdown()
        if self.transport is not None:
            self.transport.sendto(self.ctl.stop_packet())

    # ---- stream-recovery plumbing ---------------------------------------
    def _drain_ctl(self) -> None:
        if self.transport is not None:
            while self.transport.poll_ctl() is not None:
                pass

    def _frames_flowing(self) -> bool:
        if self.pump is not None:
            return self.pump.stats()["packets"] > 0
        return getattr(self.transport, "frames_flowing", lambda: False)()

    def _send_ctl_frame(self) -> None:
        """One TX frame of silence carrying two control groups — the
        state 4-7 'enable transmit' packets that tell the radio its
        receiver count (quisk.c:3476-3483)."""
        from quisk_tpu_torch.io.native import MetisStream
        ctl = np.frombuffer(self.next_ctl_group(self.mox)
                            + self.next_ctl_group(self.mox),
                            np.uint8).reshape(2, 5)
        frame = MetisStream(n_rx=self.ctl.n_rx).build_tx(
            np.zeros(126, np.complex64), ctl)
        self.transport.sendto(frame)

    def is_ready(self) -> bool:
        """Step the handshake once; True when sample frames may flow
        (the reference's quisk_hermes_is_ready return)."""
        if self.start_seq is None:
            return True
        return self.start_seq.step()

    def HeartBeat(self) -> None:
        """Housekeeping each ~100 ms: keep the handshake stepping until
        frames flow, route ACK responses to the HL2 write queue, and run
        the TX-buffer fault monitor off row 0's C3."""
        if self.start_seq is not None and not self.start_seq.running:
            self.start_seq.step()
        if self.pump is not None:
            ack = self.pump.take_ack()
            if ack is not None:
                self.hl2_queue.on_ack(ack)
            st = self.pump.hermes_status()
            self.txbuf.step(self.mox, st["h2pc"][2])

    def WriteQueue(self, five: bytes) -> None:
        """Queue a one-time ACK-gated HL2 register write; it rides the
        next due TX frame's control slot and retries until ACKed
        (hermes/quisk_hardware.py WriteQueue)."""
        self.hl2_queue.write(five)

    def recovery_stats(self) -> dict:
        """StatusBoard surface for the recovery machinery."""
        out = {"txbuf_errors": self.txbuf.errors,
               **{f"writequeue_{k}": v
                  for k, v in self.hl2_queue.stats().items()}}
        if self.start_seq is not None:
            out["start_retries"] = self.start_seq.start_retries
            out["start_state"] = self.start_seq.state
        return out

    def next_ctl_group(self, mox: bool = False) -> bytes:
        """C0..C4 for the next TX frame: a due HL2 write-queue group
        preempts the register round-robin (microphone.c:896-903)."""
        wq = self.hl2_queue.poll_tx(mox)
        if wq is not None:
            return wq
        g = self.ctl.ctl_group(self._row, mox)
        self._row = (self._row + 1) % N_CTL_ROWS
        return g

    def ChangeFrequency(self, tx_freq, vfo_freq, source="", band=""):
        self.ctl.set_tx_freq(tx_freq)
        self.ctl.set_rx_freq(0, vfo_freq)
        return super().ChangeFrequency(tx_freq, vfo_freq, source, band)

    def VarDecimGetChoices(self) -> list[int]:
        return sorted(HermesControl.RATES)

    def VarDecimSet(self, index: int) -> float:
        rate = self.VarDecimGetChoices()[index]
        self.ctl.set_rate(rate)
        return float(rate)
