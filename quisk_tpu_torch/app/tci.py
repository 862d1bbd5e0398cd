"""TCI (Transceiver Control Interface) 1.4 server over WebSocket.

Parity: the reference embeds an ExpertSDR TCI 1.4 server (tci.c, 725 LoC)
on a bundled websocket stack (ws.c 2101 LoC + sha1/base64/handshake) so
WSJT-X, loggers and panadapters can control the radio and stream audio.
Here the same shape: a from-scratch RFC 6455 WebSocket server (stdlib
only — the reference bundles its own ws.c the same way) carrying

- text frames: ``command:arg1,arg2;`` TCI commands.  Commands that change
  shared radio state are broadcast verbatim to every connected client
  (tci.c:420 ``sendframe_txt_bcast``); query forms (no value argument)
  are answered privately.  Partial commands are reassembled across frames
  until the terminating ';' (tci.c:407-428).
- binary frames: 64-byte stream headers (receiver, sample_rate, format,
  codec, crc, length, type, channels, reserved[8] — tci.c:85-96
  ``struct _Stream``) + payload.  RX_AUDIO_STREAM is pushed to clients
  that issued ``audio_start`` honoring their negotiated sample type /
  channel count, chunked at TCI_STREAM_DATA_BYTES (tci.c:532-590
  ``tci_send_audio``).  TX_AUDIO_STREAM from the client that owns
  ``trx:0,true`` feeds a circular TX buffer, refilled by pacing
  TX_CHRONO requests against the wall clock (tci.c:583-607
  ``tci_get_mic``).
"""

from __future__ import annotations

import base64
import hashlib
import socket
import socketserver
import struct
import threading
import time

import numpy as np

WS_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

# TCI binary stream types (tci.c:56-63 enum StreamType)
IQ_STREAM = 0
RX_AUDIO_STREAM = 1
TX_AUDIO_STREAM = 2
TX_CHRONO = 3
LINEOUT_STREAM = 4

# sample types (tci.c:65-71 enum SampleType)
TCI_INT16 = 0
TCI_INT24 = 1
TCI_INT32 = 2
TCI_FLOAT32 = 3

# receiver, sample_rate, format, codec, crc, length(int32), type,
# channels, reserved[8]  (tci.c:85-96) — 16 uint32 words, 64 bytes.
_HEADER = struct.Struct("<5Ii2I8I")
TCI_STREAM_DATA_BYTES = 16384           # tci.c:11

MODULATIONS = ("usb", "lsb", "cw", "am", "fm", "digl", "digu")


def pack_stream(receiver: int, sample_rate: int, samples: np.ndarray,
                stream_type: int = RX_AUDIO_STREAM, channels: int = 2,
                fmt: int = TCI_FLOAT32) -> bytes:
    """TCI binary frame: 64-byte header + float32 payload.  ``samples``
    is the flat payload (interleaved per the stream type); ``length`` in
    the header counts floats, not sample pairs (tci.c:21-24 WSJT-X
    convention)."""
    data = np.asarray(samples, np.float32)
    hdr = _HEADER.pack(receiver, sample_rate, fmt, 0, 0, data.size,
                       stream_type, channels, *([0] * 8))
    return hdr + data.tobytes()


# kept under the round-1 name for callers/tests
def pack_audio_frame(receiver: int, sample_rate: int, samples: np.ndarray,
                     stream_type: int = RX_AUDIO_STREAM) -> bytes:
    return pack_stream(receiver, sample_rate, samples, stream_type)


def unpack_stream(frame: bytes):
    """-> (receiver, sample_rate, fmt, length, stream_type, channels,
    float32 payload)."""
    rx, rate, fmt, codec, crc, length, typ, chans, *_ = \
        _HEADER.unpack_from(frame)
    avail = (len(frame) - _HEADER.size) // 4
    data = np.frombuffer(frame, np.float32, count=min(max(length, 0), avail),
                         offset=_HEADER.size)
    return rx, rate, fmt, length, typ, chans, data


def unpack_audio_frame(frame: bytes):
    """-> (receiver, sample_rate, stream_type, float32 samples)."""
    rx, rate, fmt, length, typ, chans, data = unpack_stream(frame)
    return rx, rate, typ, data


# --------------------------------------------------------- websocket layer
def _ws_accept_key(client_key: str) -> str:
    digest = hashlib.sha1((client_key + WS_GUID).encode()).digest()
    return base64.b64encode(digest).decode()


def ws_encode(payload: bytes | str, opcode: int | None = None) -> bytes:
    """Encode one unmasked server->client websocket frame."""
    if isinstance(payload, str):
        data = payload.encode()
        op = 0x1 if opcode is None else opcode
    else:
        data = payload
        op = 0x2 if opcode is None else opcode
    head = bytes([0x80 | op])
    n = len(data)
    if n < 126:
        head += bytes([n])
    elif n < 65536:
        head += bytes([126]) + struct.pack(">H", n)
    else:
        head += bytes([127]) + struct.pack(">Q", n)
    return head + data


class WsDecoder:
    """Incremental client->server frame decoder (frames are masked)."""

    def __init__(self):
        self.buf = b""

    def feed(self, data: bytes):
        """-> list of (opcode, payload bytes)."""
        self.buf += data
        out = []
        while True:
            if len(self.buf) < 2:
                return out
            b0, b1 = self.buf[0], self.buf[1]
            op = b0 & 0x0F
            masked = b1 & 0x80
            n = b1 & 0x7F
            off = 2
            if n == 126:
                if len(self.buf) < 4:
                    return out
                n = struct.unpack_from(">H", self.buf, 2)[0]
                off = 4
            elif n == 127:
                if len(self.buf) < 10:
                    return out
                n = struct.unpack_from(">Q", self.buf, 2)[0]
                off = 10
            mask = b""
            if masked:
                if len(self.buf) < off + 4:
                    return out
                mask = self.buf[off:off + 4]
                off += 4
            if len(self.buf) < off + n:
                return out
            payload = self.buf[off:off + n]
            self.buf = self.buf[off + n:]
            if mask:
                m = np.frombuffer((mask * (n // 4 + 1))[:n], np.uint8)
                payload = (np.frombuffer(payload, np.uint8) ^ m).tobytes()
            out.append((op, payload))


# -------------------------------------------------------------- TCI layer
class TciState:
    """Controlled state, shared with the application.  ``on_change(field,
    value)`` lets the owning :class:`Radio` react to client commands."""

    def __init__(self, on_change=None):
        self.vfo = [[7_050_000, 7_050_000], [14_100_000, 14_100_000]]
        self.dds = [7_000_000, 14_000_000]
        self.modulation = ["usb", "usb"]
        self.rx_enable = [True, False]
        self.trx = [False, False]          # transmit per channel
        self.split_enable = False
        self.audio_streams: set[int] = set()   # kept for round-1 callers
        self.iq_rate = 48000
        self.audio_rate = 48000
        self.lock = threading.Lock()
        self.on_change = on_change

    def _notify(self, field, value):
        if self.on_change is not None:
            self.on_change(field, value)


class _ClientCtx:
    """Per-connection stream preferences (tci.c:74-82 ClientData)."""

    def __init__(self):
        self.send_rx_audio = False
        self.samplerate = 48000
        self.sample_type = TCI_FLOAT32
        self.channels = 2
        self.bytes_per_sample = 4
        self.text_buf = ""                 # partial-command reassembly


class _TciHandler(socketserver.StreamRequestHandler):
    def handle(self):
        # HTTP upgrade handshake (parity handshake.c)
        key = None
        while True:
            line = self.rfile.readline()
            if not line or line in (b"\r\n", b"\n"):
                break
            if line.lower().startswith(b"sec-websocket-key:"):
                key = line.split(b":", 1)[1].strip().decode()
        if not key:
            return
        self.wfile.write(
            b"HTTP/1.1 101 Switching Protocols\r\n"
            b"Upgrade: websocket\r\nConnection: Upgrade\r\n"
            b"Sec-WebSocket-Accept: " + _ws_accept_key(key).encode()
            + b"\r\n\r\n")
        self.ctx = _ClientCtx()
        self.wlock = threading.Lock()
        srv: "TciServer" = self.server.owner
        st = srv.state
        # connect preamble (tci.c:349-377 onopen)
        with st.lock:
            pre = [
                "protocol:esdr,1.4;",
                "device:quisk_tpu;",
                "receive_only:false;",
                "trx_count:2;",
                "channel_count:2;",
                "vfo_limits:0,30000000;",
                "if_limits:-48000,48000;",
                f"modulations_list:{','.join(MODULATIONS)};",
                f"iq_samplerate:{st.iq_rate};",
                f"audio_samplerate:{st.audio_rate};",
                *[f"vfo:{r},{v},{st.vfo[r][v]};" for r in range(2)
                  for v in range(2)],
                *[f"modulation:{r},{st.modulation[r]};" for r in range(2)],
                *[f"trx:{r},{'true' if st.trx[r] else 'false'};"
                  for r in range(2)],
                f"split_enable:0,{'true' if st.split_enable else 'false'};",
                "tx_enable:0,true;",
                "ready;",
                "start;",
            ]
        for msg in pre:
            self._send(ws_encode(msg))
        srv.register(self)
        dec = WsDecoder()
        self.request.settimeout(0.2)
        try:
            while not self.server.closing:
                try:
                    data = self.request.recv(65536)
                except socket.timeout:
                    continue
                except OSError:
                    return
                if not data:
                    return
                for op, payload in dec.feed(data):
                    if op == 0x8:              # close
                        self._send(ws_encode(b"", opcode=0x8))
                        return
                    if op == 0x9:              # ping
                        self._send(ws_encode(payload, opcode=0xA))
                    elif op == 0x1:
                        self._on_text(srv, st, payload)
                    elif op == 0x2:
                        srv.on_binary(self, payload)
        finally:
            srv.unregister(self)

    # -- plumbing ---------------------------------------------------------
    def _send(self, frame: bytes) -> bool:
        try:
            with self.wlock:
                self.wfile.write(frame)
            return True
        except OSError:
            return False

    def _reply(self, text: str) -> None:
        self._send(ws_encode(text))

    def _on_text(self, srv, st, payload: bytes) -> None:
        # reassemble across frames until ';' (tci.c:407-428)
        self.ctx.text_buf += payload.decode(errors="replace").lower()
        while ";" in self.ctx.text_buf:
            cmd, _, self.ctx.text_buf = self.ctx.text_buf.partition(";")
            cmd = cmd.strip()
            if not cmd:
                continue
            try:
                ok = self._command(srv, st, cmd)
            except (ValueError, KeyError, IndexError, TypeError):
                ok = False       # malformed args: drop the command, not
            if ok:               # the connection (tci.c ignores bad text)
                srv.broadcast(cmd + ";")

    # -- command dispatch (tci.c:171-324 text_message) ---------------------
    # Returns True when the command should be broadcast to all clients.
    def _command(self, srv: "TciServer", st: TciState, cmd: str) -> bool:
        name, _, rest = cmd.partition(":")
        args = [a.strip() for a in rest.split(",")] if rest else []
        ctx = self.ctx
        with st.lock:
            if name == "audio_start":
                ctx.send_rx_audio = True
                st.audio_streams.add(int(args[0]) if args else 0)
                self._reply(cmd + ";")
                return False
            if name == "audio_stop":
                ctx.send_rx_audio = False
                st.audio_streams.discard(int(args[0]) if args else 0)
                self._reply(cmd + ";")
                return False
            if name == "audio_stream_sample_type":
                if args and args[0] == "float32":
                    ctx.sample_type = TCI_FLOAT32
                    ctx.bytes_per_sample = 4
                    return True
                return False               # unsupported type: no echo
            if name == "audio_samplerate":
                # only the native 48 k: we do not resample the stream, and
                # neither does the reference (tci.c:220-222 rejects !=48000)
                if args and args[0].isdigit() and int(args[0]) == 48000:
                    ctx.samplerate = 48000
                    return True
                return False
            if name == "audio_stream_channels":
                if args and args[0] in ("1", "2"):
                    ctx.channels = int(args[0])
                    return True
                return False
            if name == "audio_stream_samples":
                return False
            if name in ("iq_start", "iq_stop", "iq_samplerate"):
                if name == "iq_samplerate" and args and args[0].isdigit():
                    st.iq_rate = int(args[0])
                return False
            if name == "modulation":
                r = int(args[0]) if args else 0
                if len(args) > 1:          # set
                    if args[1] in MODULATIONS:
                        st.modulation[r] = args[1]
                        st._notify("modulation", (r, args[1]))
                        return True
                    return False
                self._reply(f"modulation:{r},{st.modulation[r]};")
                return False
            if name == "split_enable":
                if len(args) > 1:
                    st.split_enable = args[1] == "true"
                    st._notify("split_enable", st.split_enable)
                    return True
                self._reply("split_enable:0,"
                            f"{'true' if st.split_enable else 'false'};")
                return False
            if name == "trx":
                r = int(args[0]) if args else 0
                if len(args) > 1:          # set
                    want = args[1] == "true"
                    if want and not st.trx[r]:
                        srv.claim_tx(self, ctx)
                    elif not want and srv.tx_client is self:
                        srv.release_tx(self)
                    st.trx[r] = want
                    st._notify("trx", (r, want))
                    return True
                self._reply(f"trx:{r},{'true' if st.trx[r] else 'false'};")
                return False
            if name == "tx_stream_audio_buffering":
                return False
            if name == "vfo":
                r = int(args[0]) if args else 0
                v = int(args[1]) if len(args) > 1 else 0
                if len(args) > 2:          # set
                    st.vfo[r][v] = int(float(args[2]))
                    st._notify("vfo", (r, v, st.vfo[r][v]))
                    return True
                self._reply(f"vfo:{r},{v},{st.vfo[r][v]};")
                return False
            if name == "dds":
                r = int(args[0]) if args else 0
                if len(args) > 1:
                    st.dds[r] = int(float(args[1]))
                    st._notify("dds", (r, st.dds[r]))
                    return True
                self._reply(f"dds:{r},{st.dds[r]};")
                return False
            if name == "rx_enable":
                r = int(args[0]) if args else 0
                if len(args) > 1:
                    st.rx_enable[r] = args[1] == "true"
                    st._notify("rx_enable", (r, st.rx_enable[r]))
                    return True
                self._reply(
                    f"rx_enable:{r},{'true' if st.rx_enable[r] else 'false'};")
                return False
            if name == "trx_count":
                self._reply("trx_count:2;")
                return False
            if name in ("start", "stop"):
                self._reply(f"{name};")
                return True
            # unknown commands broadcast unchanged, matching the
            # reference's default `return 1` (tci.c:322-324)
            return True

    def send_audio(self, receiver: int, samples: np.ndarray,
                   rate: int) -> None:
        self._send(ws_encode(pack_stream(receiver, rate, samples)))


class TciServer:
    """Threaded TCI 1.4 server (start()/stop()).

    - :meth:`send_audio` pushes one audio block to every client that
      issued ``audio_start``, formatted per that client's negotiated
      channel count / rate and chunked at TCI_STREAM_DATA_BYTES
      (tci.c:532 ``tci_send_audio``).
    - :meth:`get_mic` returns TX mic samples from the client that owns
      ``trx`` and paces TX_CHRONO refill requests (tci.c:583
      ``tci_get_mic``).
    """

    def __init__(self, state: TciState | None = None,
                 host: str = "127.0.0.1", port: int = 40001,
                 clock=time.monotonic):
        self.state = state or TciState()
        self._srv = socketserver.ThreadingTCPServer(
            (host, port), _TciHandler, bind_and_activate=False)
        self._srv.allow_reuse_address = True
        self._srv.daemon_threads = True
        self._srv.owner = self
        self._srv.closing = False
        self.port = port
        self.clients: list[_TciHandler] = []
        self._clients_lock = threading.Lock()
        # TX audio plumbing (tci.c:45-52 + tx_buffer_mutex)
        self._clock = clock
        self._tx_lock = threading.Lock()
        self.tx_client: _TciHandler | None = None
        self._tx_buf = np.zeros(0, np.complex64)
        self._tx_request = 0               # floats per TX_CHRONO request
        self._tx_rate = 48000
        self._tx_time = 0.0
        self._tx_sent_samples = 0

    # -- client registry ---------------------------------------------------
    def register(self, h: _TciHandler) -> None:
        with self._clients_lock:
            self.clients.append(h)

    def unregister(self, h: _TciHandler) -> None:
        with self._clients_lock:
            if h in self.clients:
                self.clients.remove(h)
        if self.tx_client is h:
            self.release_tx(h)

    def broadcast(self, text: str) -> None:
        frame = ws_encode(text)
        with self._clients_lock:
            clients = list(self.clients)
        for c in clients:
            c._send(frame)

    # -- TX audio from a client (tci.c:274-302, 464-500, 583-607) ----------
    def claim_tx(self, handler: _TciHandler, ctx: _ClientCtx) -> None:
        with self._tx_lock:
            self.tx_client = handler
            self._tx_request = (TCI_STREAM_DATA_BYTES
                                // ctx.bytes_per_sample)
            self._tx_buf = np.zeros(0, np.complex64)
            self._tx_rate = ctx.samplerate
            self._tx_time = self._clock()
            self._tx_sent_samples = 0
            self._tx_channels = ctx.channels

    def release_tx(self, handler: _TciHandler) -> None:
        with self._tx_lock:
            if self.tx_client is handler:
                self.tx_client = None

    def on_binary(self, handler: _TciHandler, frame: bytes) -> None:
        if len(frame) < _HEADER.size:
            return
        rx, rate, fmt, length, typ, chans, data = unpack_stream(frame)
        if typ != TX_AUDIO_STREAM or handler is not self.tx_client:
            return
        if fmt != TCI_FLOAT32 or data.size == 0:
            return
        # 1.4 does not carry channel count in TX frames; assume stereo
        # interleave like the reference (tci.c:470 "We assume two channels")
        two = getattr(self, "_tx_channels", 2) == 2
        if two:
            n = data.size // 2 * 2
            samples = (data[0:n:2] + 1j * data[1:n:2]).astype(np.complex64)
        else:
            samples = data.astype(np.complex64)
        with self._tx_lock:
            self._tx_buf = np.concatenate([self._tx_buf, samples])

    def get_mic(self, count: int) -> np.ndarray:
        """TX mic source: drain ``count`` complex samples from the client
        buffer (zero-fill underrun) and pace TX_CHRONO refill requests
        against the wall clock (tci.c:583-607)."""
        with self._tx_lock:
            client = self.tx_client
            have = min(count, self._tx_buf.size)
            out = np.zeros(count, np.complex64)
            out[:have] = self._tx_buf[:have]
            self._tx_buf = self._tx_buf[have:]
        if client is not None:
            now = self._clock()
            if self._tx_sent_samples < (now - self._tx_time) * self._tx_rate:
                chrono = _HEADER.pack(0, self._tx_rate, TCI_FLOAT32, 0, 0,
                                      self._tx_request, TX_CHRONO, 2,
                                      *([0] * 8))
                client._send(ws_encode(chrono))
                # Stream.length counts floats, not samples (tci.c:600)
                self._tx_sent_samples += self._tx_request // 2
        return out

    # -- RX audio to clients (tci.c:532-590) --------------------------------
    def send_audio(self, stereo: np.ndarray, receiver: int = 0) -> None:
        """Push one stereo block [2, N] (or mono [N]) to every listening
        client, honoring its negotiated channel count and chunk size."""
        stereo = np.asarray(stereo, np.float32)
        if stereo.ndim == 1:
            stereo = np.stack([stereo, stereo])
        with self._clients_lock:
            clients = list(self.clients)
        for c in clients:
            ctx = getattr(c, "ctx", None)
            if ctx is None or not ctx.send_rx_audio:
                continue
            if ctx.channels == 2:
                flat = np.empty(stereo.shape[1] * 2, np.float32)
                flat[0::2] = stereo[0]
                flat[1::2] = stereo[1]
            else:
                flat = (stereo[0] + stereo[1]) * 0.5
            max_floats = TCI_STREAM_DATA_BYTES // 4
            for i in range(0, flat.size, max_floats):
                c._send(ws_encode(pack_stream(
                    receiver, ctx.samplerate, flat[i:i + max_floats],
                    RX_AUDIO_STREAM, channels=ctx.channels)))

    def tx_pending(self) -> int:
        """Buffered TX mic samples from the client (0 if no TX client)."""
        with self._tx_lock:
            return int(self._tx_buf.size) if self.tx_client else 0

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> int:
        self._srv.server_bind()
        self._srv.server_activate()
        self.port = self._srv.server_address[1]
        threading.Thread(target=self._srv.serve_forever, daemon=True).start()
        return self.port

    def stop(self) -> None:
        self._srv.closing = True
        self._srv.shutdown()
        self._srv.server_close()
