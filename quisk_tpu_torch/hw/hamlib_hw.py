"""Rig control through a Hamlib ``rigctld`` daemon.

Parity: quisk_hardware_hamlib.py (157 LoC) — the app's frequency/mode
changes are pushed to rigctld in extended-response syntax ('|F', '|M'),
and the rig is polled (alternating '|f' / '|m') so manual tuning on the
radio flows back into the app.  The state machine per 0.2 s poll tick:

1. if our mode differs from the radio's, send ``|M <mode> 0``
2. elif our frequency differs, send ``|F <freq>``
3. else alternate ``|f`` / ``|m`` polls.

Replies end in ``RPRT 0``; 'get_freq' responses update the app only when
the last *set* has been confirmed (quisk_freq == radio_freq) so a poll
racing a set cannot snap the dial back.

The socket is injectable; tests use an in-memory pair.
"""

from __future__ import annotations

import socket
import time

from quisk_tpu_torch.hw.base import Hardware, register_hardware

RIGCTLD_PORT = 4532
POLL_SECONDS = 0.2

#: Quisk mode -> hamlib mode (ChangeMode parity)
MODE_TO_HAMLIB = {"CWU": "CW", "CWL": "CW"}


def to_hamlib_mode(mode: str) -> str:
    if mode.startswith("DGT-"):
        return "USB"
    return MODE_TO_HAMLIB.get(mode, mode)


@register_hardware("hamlib")
class HamlibHardware(Hardware):
    """Frequency/mode sync with an external rigctld."""

    def __init__(self, conf=None, sock=None, clock=None,
                 port: int = RIGCTLD_PORT):
        super().__init__(conf)
        self.port = port
        self.sock = sock
        self.clock = clock or time.monotonic
        self.connected = sock is not None
        self.radio_freq: int | None = None
        self.radio_mode: str | None = None
        self.quisk_freq: int | None = None
        self.quisk_vfo: int | None = None
        self.quisk_mode = "USB"
        self.received = ""
        self._toggle = False
        self._time0 = 0.0
        #: set by ReadHamlib when the radio changed its own mode; the app
        #: picks it up from ReturnMode (reference: modeButns.SetLabel)
        self.mode_from_radio: str | None = None

    # -- lifecycle --------------------------------------------------------
    def open(self) -> str:
        if self.sock is None:
            self.sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            self.sock.settimeout(0.0)
            self._try_connect()
        self.status_text = (f"hamlib rigctld :{self.port} "
                            f"({'connected' if self.connected else 'waiting'})")
        return self.status_text

    def close(self) -> None:
        if self.sock is not None:
            self.sock.close()
        self.connected = False

    def _try_connect(self) -> bool:
        if self.connected:
            return True
        try:
            self.sock.connect(("localhost", self.port))
        except OSError:
            return False
        self.connected = True
        return True

    # -- app-side changes -------------------------------------------------
    def ChangeFrequency(self, tune, vfo, source="", band=""):
        self.quisk_freq = int(tune)
        self.quisk_vfo = int(tune)
        return self.quisk_freq, self.quisk_vfo

    def ReturnFrequency(self):
        return self.quisk_freq, self.quisk_vfo

    def ChangeMode(self, mode: str) -> None:
        self.quisk_mode = to_hamlib_mode(mode)

    # -- poll loop --------------------------------------------------------
    def HeartBeat(self) -> None:
        if not self._try_connect():
            return
        self.read_hamlib()
        if self.clock() - self._time0 < POLL_SECONDS:
            return
        self._time0 = self.clock()
        if self.quisk_mode != self.radio_mode:
            self._send(f"|M {self.quisk_mode} 0\n")
        elif self.quisk_freq != self.radio_freq:
            self._send(f"|F {self.quisk_freq}\n")
        elif self._toggle:
            self._toggle = False
            self._send("|f\n")
        else:
            self._toggle = True
            self._send("|m\n")

    def _send(self, text: str) -> None:
        try:
            self.sock.sendall(text.encode("utf-8", errors="ignore"))
        except OSError:
            self.connected = False

    def read_hamlib(self) -> None:
        """Drain the socket and apply complete replies."""
        try:
            text = self.sock.recv(1024).decode("utf-8", errors="replace")
        except OSError:
            return
        if not text:
            return
        self.received += text
        while "\n" in self.received:
            reply, self.received = self.received.split("\n", 1)
            self._handle(reply.strip())

    def _handle(self, reply: str) -> None:
        if not reply.endswith("RPRT 0"):
            return
        try:
            if reply.startswith("set_freq:"):
                freq = int(reply[9:].split("|")[0])
                self.radio_freq = freq
            elif reply.startswith("get_freq:"):
                field = reply.split("|")[1]          # 'Frequency: N'
                freq = int(field.split(":")[1])
                if self.quisk_freq == self.radio_freq:
                    self.radio_freq = freq
                    self.quisk_freq = freq
                    self.quisk_vfo = freq
            elif reply.startswith("set_mode:"):
                self.radio_mode = reply[9:].split("|")[0].split()[0]
            elif reply.startswith("get_mode:"):
                mode = reply.split("|")[1].split(":")[1].strip()
                if self.quisk_mode == self.radio_mode \
                        and self.radio_mode != mode:
                    self.radio_mode = mode
                    self.quisk_mode = mode
                    self.mode_from_radio = \
                        "CWU" if mode in ("CW", "CWR") else mode
        except (ValueError, IndexError):
            pass
