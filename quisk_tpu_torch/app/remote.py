"""Remote operation: control head <-> remote radio split.

Parity: the reference's ac2yd/ package — a control-head PC runs the GUI
while a remote PC runs the radio; they exchange a TCP control connection
authenticated with an HMAC token (remote_common.py:59+), UDP radio-sound
and graph-data streams as 16-bit blocks (remote_common.py:25-43,
ac2yd/remote.c send_graph_data/receive_graph_data), and CW key events
through a jitter buffer (quisk_tpu_torch.app.cw.KeyJitterBuffer).

Here this is the host-side streaming surface: the "remote radio" is
wherever the chains run (the card or the CPU); any number of control heads
attach for audio/spectra.
"""

from __future__ import annotations

import hashlib
import hmac
import os
import socket
import socketserver
import struct
import threading

import numpy as np

MAGIC = b"QTRC"                 # control protocol magic
AUDIO_MAGIC = 0x5154            # 'QT' UDP payload magic


# ----------------------------------------------------------- authentication
def make_challenge() -> bytes:
    return os.urandom(16)


def auth_response(secret: str, challenge: bytes) -> bytes:
    return hmac.new(secret.encode(), challenge, hashlib.sha256).digest()


def verify_response(secret: str, challenge: bytes, response: bytes) -> bool:
    return hmac.compare_digest(auth_response(secret, challenge), response)


# ------------------------------------------------------------- UDP payloads
def pack_sound(seq: int, audio: np.ndarray) -> bytes:
    """16-bit audio block with sequence number (remote_common 16-bit
    blocks; sequence numbers detect loss like the sample transports)."""
    pcm = np.clip(np.asarray(audio) * 32767.0, -32768, 32767).astype("<i2")
    return struct.pack("<HHI", AUDIO_MAGIC, 0, seq & 0xFFFFFFFF) + pcm.tobytes()


def unpack_sound(pkt: bytes):
    magic, kind, seq = struct.unpack_from("<HHI", pkt)
    if magic != AUDIO_MAGIC or kind != 0:
        return None
    pcm = np.frombuffer(pkt, "<i2", offset=8)
    return seq, pcm.astype(np.float32) / 32767.0


def pack_graph(seq: int, db_row: np.ndarray) -> bytes:
    """Graph trace quantised to 16-bit centi-dB (ac2yd sends graph rows
    over UDP the same way)."""
    q = np.clip(np.asarray(db_row) * 100.0, -32768, 32767).astype("<i2")
    return struct.pack("<HHI", AUDIO_MAGIC, 1, seq & 0xFFFFFFFF) + q.tobytes()


def unpack_graph(pkt: bytes):
    magic, kind, seq = struct.unpack_from("<HHI", pkt)
    if magic != AUDIO_MAGIC or kind != 1:
        return None
    q = np.frombuffer(pkt, "<i2", offset=8)
    return seq, q.astype(np.float32) / 100.0


class UdpStreamTx:
    """Sequence-numbered UDP sender for sound/graph rows."""

    def __init__(self, addr: tuple[str, int]):
        self.addr = addr
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.seq = 0

    def send_sound(self, audio: np.ndarray) -> None:
        self.sock.sendto(pack_sound(self.seq, audio), self.addr)
        self.seq += 1

    def send_graph(self, db_row: np.ndarray) -> None:
        self.sock.sendto(pack_graph(self.seq, db_row), self.addr)
        self.seq += 1


class UdpStreamRx:
    """Receiver counting lost packets by sequence gaps (parity: the
    reference counts sequence errors, quisk.c:3357)."""

    def __init__(self, port: int = 0, timeout: float = 0.5):
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.bind(("127.0.0.1", port))
        self.sock.settimeout(timeout)
        self.port = self.sock.getsockname()[1]
        self.expected = None
        self.lost = 0

    def recv(self):
        """-> ("sound"|"graph", payload array) or None on timeout."""
        try:
            pkt, _ = self.sock.recvfrom(65536)
        except socket.timeout:
            return None
        for kind, unpack in (("sound", unpack_sound), ("graph", unpack_graph)):
            out = unpack(pkt)
            if out is not None:
                seq, data = out
                if self.expected is not None and seq != self.expected:
                    self.lost += (seq - self.expected) & 0xFFFFFFFF
                self.expected = seq + 1
                return kind, data
        return None


# ----------------------------------------------------------- control link
class _ControlHandler(socketserver.StreamRequestHandler):
    def handle(self):
        srv = self.server
        challenge = make_challenge()
        self.wfile.write(MAGIC + challenge)
        resp = self.rfile.read(32)
        if not verify_response(srv.secret, challenge, resp):
            self.wfile.write(b"DENY")
            return
        self.wfile.write(b"OKAY")
        while True:
            line = self.rfile.readline()
            if not line:
                return
            reply = srv.dispatch(line.decode().strip())
            self.wfile.write((reply + "\n").encode())


class RemoteRadioServer:
    """The remote-radio side: authenticated TCP control + UDP streams.

    ``handlers`` maps command names to callables(args str) -> reply str;
    built-ins: freq/mode/ptt setters mirroring ac2yd control_common.
    """

    def __init__(self, secret: str, host: str = "127.0.0.1", port: int = 0):
        self.secret = secret
        self.state = {"freq": 7_050_000, "mode": "USB", "ptt": False}
        self._srv = socketserver.ThreadingTCPServer(
            (host, port), _ControlHandler, bind_and_activate=False)
        self._srv.allow_reuse_address = True
        self._srv.daemon_threads = True
        self._srv.secret = secret
        self._srv.dispatch = self._dispatch
        self.port = port

    def _dispatch(self, line: str) -> str:
        cmd, _, arg = line.partition(" ")
        if cmd == "freq":
            if arg:
                self.state["freq"] = int(arg)
            return str(self.state["freq"])
        if cmd == "mode":
            if arg:
                self.state["mode"] = arg
            return self.state["mode"]
        if cmd == "ptt":
            if arg:
                self.state["ptt"] = arg == "1"
            return "1" if self.state["ptt"] else "0"
        return "ERR unknown"

    def start(self) -> int:
        self._srv.server_bind()
        self._srv.server_activate()
        self.port = self._srv.server_address[1]
        threading.Thread(target=self._srv.serve_forever, daemon=True).start()
        return self.port

    def stop(self) -> None:
        self._srv.shutdown()
        self._srv.server_close()


class ControlHeadClient:
    """The control-head side of the TCP link."""

    def __init__(self, secret: str, host: str, port: int):
        self.sock = socket.create_connection((host, port), timeout=5)
        self.f = self.sock.makefile("rwb")
        hello = self.f.read(4 + 16)
        if hello[:4] != MAGIC:
            raise ConnectionError("bad server magic")
        self.f.write(auth_response(secret, hello[4:]))
        self.f.flush()
        status = self.f.read(4)
        if status != b"OKAY":
            raise PermissionError("authentication rejected")

    def command(self, line: str) -> str:
        self.f.write((line + "\n").encode())
        self.f.flush()
        return self.f.readline().decode().strip()

    def close(self):
        self.sock.close()
