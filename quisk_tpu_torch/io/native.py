"""ctypes bindings for the native ingest library, with NumPy fallbacks.

The C++ library (``quisk_tpu_torch/native/ingest.cpp``) provides the
host-side hot path the reference keeps in C (quisk.c:3284/3519 UDP
readers, microphone.c:721 TX framing): 24-bit sample (un)packing, HiQSDR,
Metis/Hermes and wideband frame codecs with sequence tracking, a lock-free
SPSC ring buffer and the native pump.  It is built with g++ at first use
into ``quisk_tpu_torch/_build/`` under a name that carries a hash of the
source, the flags, the compiler and the host, so an edited source is
rebuilt and a library built on another machine is never loaded.  Without
a C++ compiler every entry point takes its pure-NumPy fallback (the pumps
their Python reader); a compiler that fails on the source raises.  Tests
assert both routes agree byte-for-byte.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import platform
import shutil
import subprocess
import threading

import numpy as np

_PKG = pathlib.Path(__file__).resolve().parents[1]
SOURCE = _PKG / "native" / "ingest.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-pthread", "-shared")

_LIB = None
_LOCK = threading.Lock()


def _cxx() -> str | None:
    return shutil.which("g++")


def _target(cxx: str) -> pathlib.Path:
    h = hashlib.sha1(SOURCE.read_bytes())
    h.update(" ".join((cxx, *CXX_FLAGS)).encode())
    h.update(repr(platform.uname()).encode())
    return BUILD_DIR / f"libquisk_ingest_{h.hexdigest()[:12]}.so"


def build() -> pathlib.Path | None:
    """Compile ``native/ingest.cpp`` unless this host's build exists; the
    library's path, or None when there is no C++ compiler.  The compiler
    writes a file of this process's own and renames it into place, so
    processes building at once never load a half-written library."""
    cxx = _cxx()
    if cxx is None:
        return None
    out = _target(cxx)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"ingest library build failed:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def _find_lib():
    global _LIB
    with _LOCK:
        if _LIB is None:
            path = build()
            _LIB = _bind(ctypes.CDLL(str(path))) if path else False
    return _LIB


def _bind(lib):
    c_f32p = ctypes.POINTER(ctypes.c_float)
    c_u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.qt_unpack_iq24.argtypes = [c_u8p, ctypes.c_int64, c_f32p, c_f32p]
    lib.qt_pack_iq24.argtypes = [c_f32p, c_f32p, ctypes.c_int64, c_u8p]
    lib.qt_hiqsdr_parse.restype = ctypes.c_int64
    lib.qt_hiqsdr_build.restype = ctypes.c_int64
    lib.qt_metis_parse.restype = ctypes.c_int64
    lib.qt_metis_build.restype = ctypes.c_int64
    lib.qt_ring_create.restype = ctypes.c_void_p
    lib.qt_ring_create.argtypes = [ctypes.c_int64]
    lib.qt_ring_destroy.argtypes = [ctypes.c_void_p]
    lib.qt_ring_size.argtypes = [ctypes.c_void_p]
    lib.qt_ring_size.restype = ctypes.c_int64
    lib.qt_ring_overruns.argtypes = [ctypes.c_void_p]
    lib.qt_ring_overruns.restype = ctypes.c_int64
    lib.qt_ring_push.argtypes = [ctypes.c_void_p, c_f32p, ctypes.c_int64]
    lib.qt_ring_push.restype = ctypes.c_int64
    lib.qt_ring_pop.argtypes = [ctypes.c_void_p, c_f32p, ctypes.c_int64]
    lib.qt_ring_pop.restype = ctypes.c_int64
    lib.qt_hiqsdr_parse.argtypes = [
        c_u8p, ctypes.c_int64, c_u8p, ctypes.POINTER(ctypes.c_int64),
        c_f32p, c_f32p, c_u8p]
    lib.qt_hiqsdr_build.argtypes = [
        c_f32p, c_f32p, ctypes.c_uint8, ctypes.c_uint8, c_u8p]
    lib.qt_metis_parse.argtypes = [
        c_u8p, ctypes.c_int64, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_int64),
        c_f32p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int16), c_u8p]
    lib.qt_metis_build.argtypes = [
        c_f32p, ctypes.c_int64, ctypes.c_uint32, c_u8p, c_u8p]
    # the native pump: reader thread + recvmmsg + parse + ring, all C++
    lib.qt_pump_create.restype = ctypes.c_void_p
    lib.qt_pump_create.argtypes = [ctypes.c_int32, ctypes.c_int32,
                                   ctypes.c_char_p, ctypes.c_int32,
                                   ctypes.c_int64]
    lib.qt_pump_port.restype = ctypes.c_int32
    lib.qt_pump_port.argtypes = [ctypes.c_void_p]
    lib.qt_pump_rcvbuf.restype = ctypes.c_int32
    lib.qt_pump_rcvbuf.argtypes = [ctypes.c_void_p]
    lib.qt_pump_start.restype = ctypes.c_int32
    lib.qt_pump_start.argtypes = [ctypes.c_void_p]
    lib.qt_pump_stop.argtypes = [ctypes.c_void_p]
    lib.qt_pump_destroy.argtypes = [ctypes.c_void_p]
    lib.qt_pump_stats.argtypes = [ctypes.c_void_p,
                                  ctypes.POINTER(ctypes.c_int64)]
    lib.qt_pump_available.restype = ctypes.c_int64
    lib.qt_pump_available.argtypes = [ctypes.c_void_p]
    lib.qt_pump_read.restype = ctypes.c_int64
    lib.qt_pump_read.argtypes = [ctypes.c_void_p, ctypes.c_int32,
                                 c_f32p, ctypes.c_int64]
    lib.qt_pump_read_mic.restype = ctypes.c_int64
    lib.qt_pump_read_mic.argtypes = [ctypes.c_void_p, c_f32p,
                                     ctypes.c_int64]
    lib.qt_blast.restype = ctypes.c_int64
    lib.qt_blast.argtypes = [ctypes.c_char_p, ctypes.c_int32,
                             ctypes.c_int32, ctypes.c_int32,
                             ctypes.c_int64, ctypes.c_double]
    lib.qt_pump_hermes_status.argtypes = [ctypes.c_void_p, c_u8p]
    lib.qt_pump_overrange.restype = ctypes.c_int64
    lib.qt_pump_overrange.argtypes = [ctypes.c_void_p]
    lib.qt_pump_take_ack.restype = ctypes.c_int32
    lib.qt_pump_take_ack.argtypes = [ctypes.c_void_p, c_u8p]
    # striped wideband: per-socket sequence expectations and the position
    # of the first break
    lib.qt_pump_set_seq.argtypes = [ctypes.c_void_p, ctypes.c_uint32,
                                    ctypes.c_uint32]
    lib.qt_pump_gap_at.restype = ctypes.c_int64
    lib.qt_pump_gap_at.argtypes = [ctypes.c_void_p]
    lib.qt_blast_seq.restype = ctypes.c_int64
    lib.qt_blast_seq.argtypes = [ctypes.c_char_p, ctypes.c_int32,
                                 ctypes.c_int32, ctypes.c_int32,
                                 ctypes.c_int64, ctypes.c_double,
                                 ctypes.c_uint32, ctypes.c_uint32]
    return lib


def have_native() -> bool:
    return bool(_find_lib())


def have_native_pump() -> bool:
    """The pump is part of the library: built means both."""
    return have_native()


def _f32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _u8p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


# ------------------------------------------------------------------ iq24
def unpack_iq24(data: bytes | np.ndarray, use_native: bool | None = None
                ) -> np.ndarray:
    """Packed LE 24-bit I/Q pairs -> complex64 array."""
    raw = np.frombuffer(bytes(data), dtype=np.uint8)
    n = len(raw) // 6
    lib = _find_lib() if use_native in (None, True) else False
    if lib and use_native is not False:
        out_i = np.empty(n, np.float32)
        out_q = np.empty(n, np.float32)
        lib.qt_unpack_iq24(_u8p(raw), n, _f32p(out_i), _f32p(out_q))
        return out_i + 1j * out_q
    b = raw[: n * 6].reshape(n, 6).astype(np.int32)
    i = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)
    q = b[:, 3] | (b[:, 4] << 8) | (b[:, 5] << 16)
    i = np.where(i & 0x800000, i - 0x1000000, i)
    q = np.where(q & 0x800000, q - 0x1000000, q)
    return (i + 1j * q).astype(np.complex64) / 8388608.0


def pack_iq24(iq: np.ndarray, use_native: bool | None = None) -> bytes:
    iq = np.asarray(iq)
    n = len(iq)
    lib = _find_lib() if use_native in (None, True) else False
    if lib and use_native is not False:
        i = np.ascontiguousarray(iq.real, np.float32)
        q = np.ascontiguousarray(iq.imag, np.float32)
        out = np.empty(n * 6, np.uint8)
        lib.qt_pack_iq24(_f32p(i), _f32p(q), n, _u8p(out))
        return out.tobytes()
    ii = np.clip(iq.real, -1.0, 0.9999999)
    qq = np.clip(iq.imag, -1.0, 0.9999999)
    i = (ii * 8388608.0).astype(np.int32) & 0xFFFFFF
    q = (qq * 8388608.0).astype(np.int32) & 0xFFFFFF
    b = np.empty((n, 6), np.uint8)
    b[:, 0], b[:, 1], b[:, 2] = i & 0xFF, (i >> 8) & 0xFF, (i >> 16) & 0xFF
    b[:, 3], b[:, 4], b[:, 5] = q & 0xFF, (q >> 8) & 0xFF, (q >> 16) & 0xFF
    return b.tobytes()


# ---------------------------------------------------------------- hiqsdr
HIQSDR_PKT_LEN = 2 + 240 * 6
HIQSDR_PAIRS = 240


class HiqsdrStream:
    """Stateful HiQSDR-format packet codec with sequence-error counting."""

    def __init__(self, use_native: bool | None = None):
        self.seq = 0
        self.seq_errors = 0
        self.use_native = use_native

    def parse(self, pkt: bytes) -> tuple[np.ndarray, int] | None:
        if len(pkt) < HIQSDR_PKT_LEN:
            return None
        seq, status = pkt[0], pkt[1]
        if seq != self.seq:
            self.seq_errors += 1
        self.seq = (seq + 1) & 0xFF
        iq = unpack_iq24(pkt[2: 2 + 240 * 6], self.use_native)
        return iq, status

    def build(self, iq: np.ndarray, status: int = 0) -> bytes:
        assert len(iq) == HIQSDR_PAIRS
        pkt = bytes([self.seq & 0xFF, status]) + pack_iq24(iq, self.use_native)
        self.seq = (self.seq + 1) & 0xFF
        return pkt


# -------------------------------------------------------------- wideband
WIDEBAND_PAIRS = 8160          # 48,968-byte jumbo datagrams (codec 2)


class WidebandStream:
    """Jumbo-frame single-stream codec (native codec 2): the wideband
    ingest transport — the radio protocols are packet-rate-bound at
    ~1 KB/frame; 48 KB frames make the host path byte-bound.  Layout:
    [0xEF 0xFD][seq u32 BE][flags][0] + n iq24 pairs.

    The first packet parsed is the synchronisation point: its seq is
    adopted without an error, so joining a stream already in progress
    counts none (``synced`` turns True); after it, every packet whose
    seq is not the one expected counts one ``seq_errors``."""

    def __init__(self, use_native: bool | None = None):
        self.seq = 0
        self.seq_errors = 0
        self.synced = False
        self.use_native = use_native

    def parse(self, pkt: bytes) -> np.ndarray | None:
        if len(pkt) < 8 or pkt[0] != 0xEF or pkt[1] != 0xFD:
            return None
        seq = int.from_bytes(pkt[2:6], "big")
        if not self.synced:
            self.seq, self.synced = seq, True
        if seq != self.seq:
            self.seq_errors += 1
        self.seq = (seq + 1) & 0xFFFFFFFF
        n = (len(pkt) - 8) // 6
        return unpack_iq24(pkt[8: 8 + n * 6], self.use_native)

    def build(self, iq: np.ndarray, flags: int = 0) -> bytes:
        pkt = (bytes([0xEF, 0xFD]) + int(self.seq).to_bytes(4, "big")
               + bytes([flags & 0xFF, 0]) + pack_iq24(iq, self.use_native))
        self.seq = (self.seq + 1) & 0xFFFFFFFF
        return pkt


# ----------------------------------------------------------------- metis
METIS_FRAME_LEN = 1032


def metis_samples_per_frame(n_rx: int) -> int:
    return 2 * ((512 - 8) // (n_rx * 6 + 2))


class MetisStream:
    """Metis/Hermes protocol-1 frame codec (RX parse + TX build)."""

    def __init__(self, n_rx: int = 1, use_native: bool | None = None):
        self.n_rx = n_rx
        self.seq = 0
        self.seq_errors = 0
        self.use_native = use_native

    def parse(self, frame: bytes):
        """-> (iq [n_rx, ns] complex64, mic int16 [ns], ctl [2,5]) or None."""
        ns_max = metis_samples_per_frame(self.n_rx)
        lib = _find_lib() if self.use_native in (None, True) else False
        if lib and self.use_native is not False:
            raw = np.frombuffer(frame, np.uint8)
            out = np.zeros((self.n_rx, 2 * ns_max), np.float32)
            mic = np.zeros(ns_max, np.int16)
            ctl = np.zeros(10, np.uint8)
            seq_state = ctypes.c_uint32(self.seq)
            seq_err = ctypes.c_int64(self.seq_errors)
            ns = lib.qt_metis_parse(
                _u8p(raw), len(frame), self.n_rx,
                ctypes.byref(seq_state), ctypes.byref(seq_err),
                _f32p(out), out.shape[1],
                mic.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), _u8p(ctl))
            self.seq, self.seq_errors = seq_state.value, seq_err.value
            if ns < 0:
                return None
            iq = out[:, : 2 * ns].reshape(self.n_rx, ns, 2)
            return (iq[..., 0] + 1j * iq[..., 1]).astype(np.complex64), \
                mic[:ns], ctl.reshape(2, 5)
        return self._parse_np(frame)

    def _parse_np(self, frame: bytes):
        if (len(frame) < METIS_FRAME_LEN or frame[0] != 0xEF
                or frame[1] != 0xFE or frame[2] != 0x01):
            return None
        seq = int.from_bytes(frame[4:8], "big")
        if seq != self.seq:
            self.seq_errors += 1
        self.seq = (seq + 1) & 0xFFFFFFFF
        group = self.n_rx * 6 + 2
        count = (512 - 8) // group
        iq_all, mic_all, ctl = [], [], []
        for sub in range(2):
            f = frame[8 + sub * 512: 8 + (sub + 1) * 512]
            if f[:3] != b"\x7f\x7f\x7f":
                return None
            ctl.append(np.frombuffer(f[3:8], np.uint8))
            body = np.frombuffer(f[8: 8 + count * group], np.uint8
                                 ).reshape(count, group).astype(np.int64)
            for r in range(self.n_rx):
                o = r * 6
                i = (body[:, o] << 16) | (body[:, o + 1] << 8) | body[:, o + 2]
                q = (body[:, o + 3] << 16) | (body[:, o + 4] << 8) | body[:, o + 5]
                i = np.where(i & 0x800000, i - 0x1000000, i)
                q = np.where(q & 0x800000, q - 0x1000000, q)
                if len(iq_all) <= r:
                    iq_all.append([])
                iq_all[r].append((i + 1j * q) / 8388608.0)
            m = (body[:, self.n_rx * 6].astype(np.int16) << 8) | \
                body[:, self.n_rx * 6 + 1].astype(np.int16)
            mic_all.append(m.astype(np.int16))
        iq = np.stack([np.concatenate(ch) for ch in iq_all]).astype(np.complex64)
        return iq, np.concatenate(mic_all), np.stack(ctl)

    def build_tx(self, iq: np.ndarray, ctl: np.ndarray) -> bytes:
        """TX frame: iq [>=126] complex, ctl [2,5] uint8 -> 1032 bytes."""
        lib = _find_lib() if self.use_native in (None, True) else False
        n = len(iq)
        inter = np.empty(2 * n, np.float32)
        inter[0::2] = np.clip(iq.real, -1, 0.9999999)
        inter[1::2] = np.clip(iq.imag, -1, 0.9999999)
        ctl = np.ascontiguousarray(ctl, np.uint8).reshape(10)
        if lib and self.use_native is not False:
            out = np.zeros(METIS_FRAME_LEN, np.uint8)
            r = lib.qt_metis_build(_f32p(inter), n, self.seq, _u8p(ctl),
                                   _u8p(out))
            if r < 0:
                raise ValueError("need >= 126 samples per frame")
            self.seq = (self.seq + 1) & 0xFFFFFFFF
            return out.tobytes()
        # numpy fallback
        if n < 126:
            raise ValueError("need >= 126 samples per frame")
        out = bytearray(METIS_FRAME_LEN)
        out[0:4] = b"\xef\xfe\x01\x02"
        out[4:8] = int(self.seq).to_bytes(4, "big")
        k = 0
        for sub in range(2):
            base = 8 + sub * 512
            out[base: base + 3] = b"\x7f\x7f\x7f"
            out[base + 3: base + 8] = ctl[sub * 5:(sub + 1) * 5].tobytes()
            count = (512 - 8) // 8
            for g in range(count):
                i = int(inter[2 * k] * 8388608.0)
                q = int(inter[2 * k + 1] * 8388608.0)
                s = base + 8 + g * 8
                out[s: s + 3] = (i & 0xFFFFFF).to_bytes(3, "big")
                out[s + 3: s + 6] = (q & 0xFFFFFF).to_bytes(3, "big")
                k += 1
        self.seq = (self.seq + 1) & 0xFFFFFFFF
        return bytes(out)


# ------------------------------------------------------------------ ring
def parse_bandscope_frame(frame: bytes) -> np.ndarray | None:
    """Hermes EP4 wideband bandscope frame -> raw ADC samples [-1, 1).

    Parity: quisk.c:3589-3616 — endpoint-4 frames carry 512 16-bit
    little-endian raw ADC samples of the full 0..clock/2 band (no USB
    sub-frame structure, unlike EP6); the app windows+FFTs them for the
    bandscope display (quisk_tpu_torch.app.graph.BandscopeService).
    """
    if len(frame) < 16 or frame[0] != 0xEF or frame[1] != 0xFE \
            or frame[2] != 0x01 or frame[3] != 0x04:
        return None
    pcm = np.frombuffer(frame, "<i2", offset=8)
    return pcm.astype(np.float32) / 32768.0


def build_bandscope_frame(adc: np.ndarray, seq: int = 0) -> bytes:
    """EP4 frame builder (tests / hardware simulators)."""
    pcm = np.clip(np.asarray(adc) * 32768.0, -32768, 32767).astype("<i2")
    head = bytes([0xEF, 0xFE, 0x01, 0x04]) + int(seq).to_bytes(4, "big")
    return head + pcm.tobytes()


class Ring:
    """SPSC float32 ring buffer (native if built, else NumPy deque-style)."""

    def __init__(self, capacity_floats: int, use_native: bool | None = None):
        lib = _find_lib() if use_native in (None, True) else False
        self._lib = lib if (lib and use_native is not False) else None
        if self._lib:
            self._h = self._lib.qt_ring_create(capacity_floats)
        else:
            cap = 1
            while cap < capacity_floats:
                cap <<= 1
            self._buf = np.empty(cap, np.float32)
            self._cap = cap
            self._head = 0
            self._tail = 0
            self.overruns = 0

    def push(self, data: np.ndarray) -> int:
        data = np.ascontiguousarray(data, np.float32)
        if self._lib:
            return self._lib.qt_ring_push(self._h, _f32p(data), len(data))
        n = len(data)
        space = self._cap - (self._head - self._tail)
        if n > space:
            self.overruns += 1
            n = space
        idx = (self._head + np.arange(n)) & (self._cap - 1)
        self._buf[idx] = data[:n]
        self._head += n
        return n

    def pop(self, n: int) -> np.ndarray:
        if self._lib:
            out = np.empty(n, np.float32)
            got = self._lib.qt_ring_pop(self._h, _f32p(out), n)
            return out[:got]
        avail = self._head - self._tail
        n = min(n, avail)
        idx = (self._tail + np.arange(n)) & (self._cap - 1)
        out = self._buf[idx].copy()
        self._tail += n
        return out

    def __len__(self):
        if self._lib:
            return int(self._lib.qt_ring_size(self._h))
        return self._head - self._tail

    def overrun_count(self) -> int:
        if self._lib:
            return int(self._lib.qt_ring_overruns(self._h))
        return self.overruns

    def __del__(self):
        if getattr(self, "_lib", None):
            self._lib.qt_ring_destroy(self._h)
