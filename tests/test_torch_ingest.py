"""The port's ingest plane (quisk_tpu_torch/io/{native,pump}.py on its own
g++ build of quisk_tpu_torch/native/ingest.cpp) against the JAX package's
(quisk_tpu/io/{native,pump}.py on native/libquisk_ingest.so): the codecs
byte for byte on both the native and the NumPy routes, the ring, the
pumps reassembling the same packet lists into the same blocks, the TX
pacer, reading into a caller's buffer, DeviceFeed's in-place fill, and a
block larger than the default ring through the wideband plugin.

Two behaviours differ on purpose, each shown beside the reference's:
joining a wideband stream in progress counts no sequence error in the
port (the first packet is the synchronisation point), and a datagram lost
on one socket of a striped capture makes the port's StripedPump raise
(``desynced``) where the reference returns misplaced chunks.

Sockets bind ephemeral localhost ports.  Senders wait for the pumps to
count what was sent, so no test depends on the host's speed."""

import pathlib
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from quisk_tpu.io import native as jnative
from quisk_tpu.io import pump as jpump

from quisk_tpu_torch.hw import get_hardware
from quisk_tpu_torch.io import native, pump
from quisk_tpu_torch.io.feed import DeviceFeed

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKT = native.WIDEBAND_PAIRS


@pytest.fixture(scope="module")
def built():
    """Both native libraries: the port's (built by g++ at first use) and
    the reference's (built by its Makefile, as tests/test_native.py)."""
    if not jnative.have_native():
        subprocess.run(["make", "-C", str(ROOT / "native")], check=False,
                       capture_output=True)
        jnative._LIB = None
    assert jnative.have_native(), "reference ingest library not built"
    assert native.have_native_pump(), "port ingest library not built"
    return True


def _iq(n, seed=0, scale=0.25):
    rng = np.random.default_rng(seed)
    z = (rng.standard_normal(n) + 1j * rng.standard_normal(n)) * scale
    return z.astype(np.complex64)


def _wait(cond, timeout=10.0):
    t0 = time.time()
    while not cond() and time.time() - t0 < timeout:
        time.sleep(0.002)
    assert cond(), "timed out waiting for the pump"


def _send(pkts, addrs, pumps, chunk=8):
    """Send every packet to every address, ``chunk`` at a time, waiting
    after each chunk until every pump has counted them (no loss from a
    full socket buffer, whatever the host's load)."""
    sk = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    base = [pm.stats()["packets"] for pm in pumps]
    try:
        for k in range(0, len(pkts), chunk):
            for p in pkts[k:k + chunk]:
                for a in addrs:
                    sk.sendto(p, a)
            done = min(len(pkts), k + chunk)
            for pm, b in zip(pumps, base):
                _wait(lambda pm=pm, b=b: pm.stats()["packets"] >= b + done)
    finally:
        sk.close()


def _metis_rx_frames(iq, n_rx):
    """Radio->PC Metis frames carrying ``iq`` [n_rx, n] (the layout of
    tests/test_pump.py), mic = sample index, ctl groups row by frame."""
    ns = native.metis_samples_per_frame(n_rx)
    group = n_rx * 6 + 2
    count = (512 - 8) // group
    frames = []
    for f in range(iq.shape[1] // ns):
        out = bytearray(1032)
        out[0:4] = b"\xef\xfe\x01\x06"
        out[4:8] = int(f).to_bytes(4, "big")
        for sub in range(2):
            base = 8 + sub * 512
            out[base:base + 3] = b"\x7f\x7f\x7f"
            out[base + 3:base + 8] = bytes([(f % 5) << 3, f & 0xFF, sub,
                                            3, 4])
            for g in range(count):
                k = f * ns + sub * count + g
                s = base + 8 + g * group
                for r in range(n_rx):
                    i = int(iq[r, k].real * 8388608.0) & 0xFFFFFF
                    q = int(iq[r, k].imag * 8388608.0) & 0xFFFFFF
                    out[s + r * 6:s + r * 6 + 3] = i.to_bytes(3, "big")
                    out[s + r * 6 + 3:s + r * 6 + 6] = q.to_bytes(3, "big")
                out[s + n_rx * 6:s + group] = (k & 0x7FFF).to_bytes(2, "big")
        frames.append(bytes(out))
    return frames


def _wideband_pkts(n_pkts, seed=0, seq0=0):
    ws = native.WidebandStream(use_native=False)
    ws.seq = seq0
    iq = _iq(n_pkts * PKT, seed)
    return [ws.build(iq[k * PKT:(k + 1) * PKT]) for k in range(n_pkts)], iq


# ------------------------------------------------------------ the build
def test_port_loads_its_own_build(built):
    lib = native._find_lib()
    path = pathlib.Path(lib._name)
    assert path.parent == native.BUILD_DIR
    assert path.name.startswith("libquisk_ingest_") and path.exists()
    assert path != ROOT / "native" / "libquisk_ingest.so"
    # no flag that ties the library to this host's CPU
    assert "-march=native" not in native.CXX_FLAGS


def test_build_is_atomic_across_processes(tmp_path):
    """Two processes building at once into an empty directory both come
    back with the same complete library, and leave no temporary file."""
    code = ("import pathlib, sys, ctypes\n"
            "from quisk_tpu_torch.io import native\n"
            "native.BUILD_DIR = pathlib.Path(sys.argv[1])\n"
            "p = native.build()\n"
            "ctypes.CDLL(str(p)).qt_ring_create\n"
            "print(p)\n")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              cwd=ROOT, stdout=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=120)[0].strip() for p in procs]
    assert all(p.returncode == 0 for p in procs)
    assert outs[0] == outs[1]
    assert sorted(f.name for f in tmp_path.iterdir()) == \
        [pathlib.Path(outs[0]).name]


def test_no_compiler_takes_the_numpy_fallback(monkeypatch):
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_cxx", lambda: None)
    assert not native.have_native() and not native.have_native_pump()
    iq = _iq(300, seed=4)
    assert native.pack_iq24(iq) == jnative.pack_iq24(iq, use_native=False)
    p = pump.make_pump("hiqsdr")
    p.stop()
    assert isinstance(p, pump.UdpPump)


# --------------------------------------------------------------- codecs
ROUTES = pytest.mark.parametrize("route", [True, False],
                                 ids=["native", "numpy"])


@ROUTES
@pytest.mark.parametrize("scale", [0.25, 2.0], ids=["inside", "clipping"])
def test_iq24_pack_unpack_equal_the_reference(built, route, scale):
    iq = _iq(1001, seed=1, scale=scale)
    b = native.pack_iq24(iq, route)
    assert b == jnative.pack_iq24(iq, route)
    assert b == jnative.pack_iq24(iq, not route)
    got = native.unpack_iq24(b, route)
    np.testing.assert_array_equal(got, jnative.unpack_iq24(b, route))
    np.testing.assert_array_equal(got, native.unpack_iq24(b, not route))


@ROUTES
def test_hiqsdr_codec_equals_the_reference(built, route):
    tx, jtx = native.HiqsdrStream(route), jnative.HiqsdrStream(route)
    sent = [_iq(240, seed=i) for i in range(300)]   # past the u8 wrap
    pkts = [tx.build(s, status=i & 7) for i, s in enumerate(sent)]
    assert pkts == [jtx.build(s, status=i & 7) for i, s in enumerate(sent)]
    del pkts[5]
    rx, jrx = native.HiqsdrStream(route), jnative.HiqsdrStream(route)
    for p in pkts:
        (a, sa), (b, sb) = rx.parse(p), jrx.parse(p)
        np.testing.assert_array_equal(a, b)
        assert sa == sb
    assert rx.seq_errors == jrx.seq_errors == 1
    assert rx.parse(pkts[0][:100]) is None


@ROUTES
def test_wideband_codec_equals_the_reference(built, route):
    tx, jtx = native.WidebandStream(route), jnative.WidebandStream(route)
    iq = _iq(3 * PKT + 17, seed=2)
    chunks = [iq[:PKT], iq[PKT:2 * PKT], iq[2 * PKT:]]
    pkts = [tx.build(c, flags=k) for k, c in enumerate(chunks)]
    assert pkts == [jtx.build(c, flags=k) for k, c in enumerate(chunks)]
    rx, jrx = native.WidebandStream(route), jnative.WidebandStream(route)
    for p in pkts:
        np.testing.assert_array_equal(rx.parse(p), jrx.parse(p))
    assert rx.seq_errors == jrx.seq_errors == 0
    assert rx.parse(b"\xef\xfc" + pkts[0][2:]) is None


@ROUTES
@pytest.mark.parametrize("n_rx", [1, 2, 4])
def test_metis_codec_equals_the_reference(built, route, n_rx):
    ns = native.metis_samples_per_frame(n_rx)
    rng = np.random.default_rng(n_rx)
    iq = np.stack([_iq(3 * ns, seed=n_rx * 10 + r) for r in range(n_rx)])
    frames = _metis_rx_frames(iq, n_rx)
    del frames[1]
    rx, jrx = native.MetisStream(n_rx, route), jnative.MetisStream(n_rx,
                                                                   route)
    for f in frames:
        a, b = rx.parse(f), jrx.parse(f)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    assert rx.seq_errors == jrx.seq_errors == 1
    assert rx.parse(b"\x00" * 1032) is None and jrx.parse(b"\x00" * 1032) \
        is None
    ctl = rng.integers(0, 256, (2, 5)).astype(np.uint8)
    tx, jtx = native.MetisStream(1, route), jnative.MetisStream(1, route)
    for k in range(3):
        frame = tx.build_tx(_iq(126, seed=k, scale=0.6), ctl)
        assert frame == jtx.build_tx(_iq(126, seed=k, scale=0.6), ctl)
    with pytest.raises(ValueError):
        tx.build_tx(_iq(125), ctl)


def test_bandscope_frames_equal_the_reference():
    adc = 0.7 * np.sin(np.arange(512) * 0.3)
    frame = native.build_bandscope_frame(adc, seq=9)
    assert frame == jnative.build_bandscope_frame(adc, seq=9)
    np.testing.assert_array_equal(native.parse_bandscope_frame(frame),
                                  jnative.parse_bandscope_frame(frame))
    assert native.parse_bandscope_frame(b"\xEF\xFE\x01\x06" + bytes(1028)) \
        is None


@ROUTES
def test_ring_equals_the_reference(built, route):
    r, jr = native.Ring(1 << 12, route), jnative.Ring(1 << 12, route)
    rng = np.random.default_rng(5)
    for n_push, n_pop in ((3000, 1000), (5000, 100), (10, 7000),
                          (4096, 4096), (1, 0)):
        data = rng.standard_normal(n_push).astype(np.float32)
        assert r.push(data) == jr.push(data)
        np.testing.assert_array_equal(r.pop(n_pop), jr.pop(n_pop))
        assert len(r) == len(jr)
        assert r.overrun_count() == jr.overrun_count()
    assert r.overrun_count() >= 1


# ---------------------------------------------------------------- pumps
def _pump_pair(kind, codec, n_rx):
    """A port pump and the reference's, of one kind, for ``codec``."""
    if kind == "native":
        return (pump.NativePump(codec, n_rx=n_rx, ring_samples=1 << 20),
                jpump.NativePump(codec, n_rx=n_rx, ring_samples=1 << 20))
    mk = {"hiqsdr": lambda m: m.HiqsdrStream(use_native=False),
          "metis": lambda m: m.MetisStream(n_rx, use_native=False),
          "wideband": lambda m: m.WidebandStream(use_native=False)}[codec]
    return (pump.UdpPump(mk(native), n_rx=n_rx, ring_samples=1 << 20),
            jpump.UdpPump(mk(jnative), n_rx=n_rx, ring_samples=1 << 20))


def _close(p):
    p.stop()
    if hasattr(p, "close"):
        p.close()


def _packets(codec, n_rx):
    if codec == "hiqsdr":
        tx = native.HiqsdrStream(use_native=False)
        iq = _iq(60 * 240, seed=6)
        return [tx.build(iq[k:k + 240]) for k in range(0, iq.size, 240)], \
            60 * 240
    if codec == "metis":
        ns = native.metis_samples_per_frame(n_rx)
        iq = np.stack([_iq(40 * ns, seed=7 + r) for r in range(n_rx)])
        return _metis_rx_frames(iq, n_rx), 40 * ns
    pkts, _ = _wideband_pkts(12, seed=8)
    return pkts, 12 * PKT


@pytest.mark.parametrize("kind", ["native", "python"])
@pytest.mark.parametrize("codec,n_rx", [("hiqsdr", 1), ("metis", 2),
                                        ("wideband", 1)])
def test_pumps_reassemble_the_same_blocks(built, kind, codec, n_rx):
    pkts, n = _packets(codec, n_rx)
    p, jp = _pump_pair(kind, codec, n_rx)
    try:
        p.start()
        jp.start()
        _send(pkts, [p.local_addr, jp.local_addr], [p, jp])
        a, b = p.read_samples(n), jp.read_samples(n)
        assert a is not None and a.shape == (n_rx, n)
        np.testing.assert_array_equal(a, b)
        st, jst = p.stats(), jp.stats()
        for k in ("packets", "bad_packets", "samples", "seq_errors",
                  "ring_overruns"):
            assert st[k] == jst[k], k
        assert st["seq_errors"] == 0
        if codec == "metis":
            np.testing.assert_array_equal(p.read_mic(n), jp.read_mic(n))
            assert p.hermes_status() == jp.hermes_status()
        assert p.read_samples(1) is None and p.stats()["starved"] == 1
    finally:
        _close(p)
        _close(jp)


@pytest.mark.parametrize("native_members", [True, False],
                         ids=["NativePump", "make_pump"])
def test_multipump_equals_the_reference(built, native_members):
    mp = pump.MultiPump("hiqsdr", n_pumps=2, native=native_members)
    jmp = jpump.MultiPump("hiqsdr", n_pumps=2, native=native_members)
    try:
        mp.start()
        jmp.start()
        assert mp.read_samples(240) is None and jmp.read_samples(240) is None
        for i in range(2):
            tx = native.HiqsdrStream(use_native=False)
            iq = _iq(20 * 240, seed=20 + i)
            pkts = [tx.build(iq[k:k + 240]) for k in range(0, iq.size, 240)]
            _send(pkts, [mp.local_addrs[i], jmp.local_addrs[i]],
                  [mp.pumps[i], jmp.pumps[i]])
        a, b = mp.read_samples(20 * 240), jmp.read_samples(20 * 240)
        assert a.shape == (2, 20 * 240)
        np.testing.assert_array_equal(a, b)
        assert mp.stats()["starved"] == jmp.stats()["starved"] == 1
    finally:
        mp.stop()
        mp.close()
        jmp.stop()
        jmp.close()


def _striped_send(pkts, sps, n_sock):
    """Send packet k to socket k % n_sock of every StripedPump in ``sps``,
    waiting on each socket's pump."""
    sk = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        sent = [0] * n_sock
        for k, p in enumerate(pkts):
            i = k % n_sock
            for sp in sps:
                sk.sendto(p, sp.local_addrs[i])
            sent[i] += 1
            for sp in sps:
                _wait(lambda sp=sp, i=i: sp.pumps[i].stats()["packets"]
                      >= sent[i])
    finally:
        sk.close()


def test_striped_pump_equals_the_reference(built):
    pkts, iq = _wideband_pkts(8, seed=9)
    sp, jsp = pump.StripedPump(2, ring_samples=1 << 20), \
        jpump.StripedPump(2, ring_samples=1 << 20)
    try:
        sp.start()
        jsp.start()
        _striped_send(pkts, [sp, jsp], 2)
        a, b = sp.read_samples(8 * PKT), jsp.read_samples(8 * PKT)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(
            a[0], native.unpack_iq24(b"".join(p[8:] for p in pkts)))
        assert sp.stats()["seq_errors"] == 0 and not sp.desynced
        with pytest.raises(ValueError):
            sp.read_samples(PKT)
    finally:
        sp.close()
        jsp.close()


def test_striped_pump_lost_datagram_raises_where_the_reference_misplaces(
        built):
    """ADVICE fix 1.  Packet 5 (socket 1) is lost.  Blocks before it come
    back right in both; the block that reaches past it makes the port
    raise (and every later call), where the reference returns socket 1's
    later chunks in the wrong time slots."""
    pkts, _ = _wideband_pkts(14, seed=10)
    want = [native.unpack_iq24(p[8:]) for p in pkts]
    sp, jsp = pump.StripedPump(2, ring_samples=1 << 20), \
        jpump.StripedPump(2, ring_samples=1 << 20)
    try:
        sp.start()
        jsp.start()
        kept = [p for k, p in enumerate(pkts) if k != 5]
        sk = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        for p in kept:
            seq = int.from_bytes(p[2:6], "big")
            for s in (sp, jsp):
                sk.sendto(p, s.local_addrs[seq % 2])
        sk.close()
        for s in (sp, jsp):
            _wait(lambda s=s: s.stats()["packets"] == len(kept))
        # packets 0-3 lie before the gap: the same, right blocks
        a, b = sp.read_samples(4 * PKT), jsp.read_samples(4 * PKT)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a[0], np.concatenate(want[:4]))
        assert sp.stats()["seq_errors"] == jsp.stats()["seq_errors"] == 1
        # the next block would hold packet 5's slot
        with pytest.raises(RuntimeError, match="desynced"):
            sp.read_samples(4 * PKT)
        assert sp.desynced and sp.stats()["desynced"]
        with pytest.raises(RuntimeError, match="desynced"):
            sp.read_samples(2 * PKT)
        jb = jsp.read_samples(4 * PKT)[0].reshape(4, PKT)
        # reference: slot 5 holds packet 7, slot 7 holds packet 9
        np.testing.assert_array_equal(jb[0], want[4])
        np.testing.assert_array_equal(jb[1], want[7])
        np.testing.assert_array_equal(jb[3], want[9])
    finally:
        sp.close()
        jsp.close()


def _seq_join_packets():
    """Three wideband packets of a stream already at seq 1000."""
    pkts, _ = _wideband_pkts(3, seed=11, seq0=1000)
    return pkts


def test_wideband_codec_joins_a_stream_in_progress():
    """ADVICE fix 2, Python codec: the first packet is the sync point in
    the port; the reference expects seq 0 and counts one error."""
    for route in (True, False):
        rx, jrx = native.WidebandStream(route), jnative.WidebandStream(route)
        for p in _seq_join_packets():
            np.testing.assert_array_equal(rx.parse(p), jrx.parse(p))
        assert rx.synced and rx.seq == jrx.seq == 1003
        assert (rx.seq_errors, jrx.seq_errors) == (0, 1)
        rx.parse(_seq_join_packets()[0])        # seq 1000 again: a break
        assert rx.seq_errors == 1


def test_native_pump_joins_a_stream_in_progress(built):
    """ADVICE fix 2, native pump (qt_wideband_parse): 0 errors in the
    port, 1 in the reference; a later break still counts."""
    p, jp = _pump_pair("native", "wideband", 1)
    try:
        p.start()
        jp.start()
        pkts = _seq_join_packets()
        _send(pkts, [p.local_addr, jp.local_addr], [p, jp])
        assert (p.stats()["seq_errors"], jp.stats()["seq_errors"]) == (0, 1)
        np.testing.assert_array_equal(p.read_samples(3 * PKT),
                                      jp.read_samples(3 * PKT))
        _send([pkts[0]], [p.local_addr], [p])
        assert p.stats()["seq_errors"] == 1
    finally:
        _close(p)
        _close(jp)


def test_tx_pacer_equals_the_reference():
    p = pump.TxPacer(rx_rate=48000.0, tx_rate=192000.0,
                     max_credit_samples=8192)
    jp = jpump.TxPacer(rx_rate=48000.0, tx_rate=192000.0,
                       max_credit_samples=8192)
    rng = np.random.default_rng(12)
    for _ in range(200):
        if rng.random() < 0.5:
            n = int(rng.integers(0, 4000))
            p.on_rx_samples(n)
            jp.on_rx_samples(n)
        else:
            n = int(rng.integers(1, 3000))
            assert p.try_send(n) == jp.try_send(n)
        assert p.credit == jp.credit
    assert (p.sent, p.blocked) == (jp.sent, jp.blocked)
    assert p.blocked > 0 and p.sent > 0


def test_packet_sender_sends_the_reference_bytes():
    rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rx.bind(("127.0.0.1", 0))
    rx.settimeout(5.0)
    iq = _iq(5 * 240, seed=13)
    try:
        got = []
        for m, mp in ((native, pump), (jnative, jpump)):
            tx = m.HiqsdrStream(use_native=False)
            s = mp.PacketSender(lambda b, tx=tx: tx.build(b),
                                rx.getsockname(), 240)
            assert s.send_stream(iq) == 5
            s.close()
            got.append([rx.recv(2048) for _ in range(5)])
        assert got[0] == got[1]
    finally:
        rx.close()


def test_make_pump_picks_the_native_pump(built):
    made = [pump.make_pump("hiqsdr"),
            pump.make_pump(native.MetisStream(n_rx=2)),
            pump.make_pump(native.WidebandStream()),
            pump.make_pump(native.HiqsdrStream(use_native=False))]
    try:
        assert [type(p).__name__ for p in made] == \
            ["NativePump", "NativePump", "NativePump", "UdpPump"]
        assert made[1].n_rx == 2 and made[2].codec_name == "wideband"
        assert made[0].stats()["native"] is True
    finally:
        for p in made:
            _close(p)


def test_blasters_feed_the_port_pumps(built):
    """The port's native blasters into its pumps: the ramp payload of
    qt_blast, zero loss, on one socket and striped over two."""
    p = pump.NativePump("wideband", ring_samples=1 << 21)
    sp = pump.StripedPump(2, ring_samples=1 << 21)
    try:
        p.start()
        sp.start()
        t = threading.Thread(target=pump.blast, args=(p.local_addr,),
                             kwargs=dict(codec="wideband", n_packets=20,
                                         pace_pps=2000.0))
        t.start()
        assert pump.blast_striped(sp.local_addrs, 20, pace_pps=2000.0) == 20
        t.join(timeout=10.0)
        assert not t.is_alive()
        _wait(lambda: p.available() >= 20 * PKT
              and sp.available() >= 20 * PKT)
        want = ((np.arange(20 * PKT) % PKT) % 1024) / 2048.0
        for blk in (p.read_samples(20 * PKT), sp.read_samples(20 * PKT)):
            np.testing.assert_allclose(blk[0].real, want, atol=1e-6)
            np.testing.assert_allclose(blk[0].imag, -want, atol=1e-6)
        for st in (p.stats(), sp.stats()):
            assert st["seq_errors"] == 0 and st["ring_overruns"] == 0
    finally:
        _close(p)
        sp.close()


# --------------------------------------------------- reading into a buffer
def _fill_pumps(kind):
    """A started port pump of ``kind`` holding 6 wideband packets (12 for
    MultiPump, 6 a member); (pump, rows, n)."""
    pkts, _ = _wideband_pkts(6, seed=14)
    if kind == "striped":
        p = pump.StripedPump(2, ring_samples=1 << 20)
        p.start()
        _striped_send(pkts, [p], 2)
        return p, 1, 6 * PKT
    if kind == "multi":
        p = pump.MultiPump("wideband", n_pumps=2, ring_samples=1 << 20)
        p.start()
        for i in range(2):
            _send(pkts, [p.local_addrs[i]], [p.pumps[i]])
        return p, 2, 6 * PKT
    p = (pump.NativePump("wideband", ring_samples=1 << 20) if kind ==
         "native" else pump.UdpPump(native.WidebandStream(use_native=False),
                                    ring_samples=1 << 20))
    p.start()
    _send(pkts, [p.local_addr], [p])
    return p, 1, 6 * PKT


@pytest.mark.parametrize("out_kind", ["numpy", "tensor"])
@pytest.mark.parametrize("kind", ["native", "python", "multi", "striped"])
def test_read_into_out_equals_read_samples(built, kind, out_kind):
    """The same packets into two pumps of one kind: read_samples(n, out)
    fills ``out`` with read_samples(n)'s block and returns ``out``."""
    (a, rows, n), (b, _, _) = _fill_pumps(kind), _fill_pumps(kind)
    try:
        want = a.read_samples(n)
        out = (np.full((rows, n), np.nan, np.complex64) if out_kind ==
               "numpy" else torch.full((rows, n), float("nan"),
                                       dtype=torch.complex64))
        assert b.read_samples(n, out=out) is out
        got = out if out_kind == "numpy" else out.numpy()
        np.testing.assert_array_equal(got, want)
        assert b.read_samples(n, out=out) is None       # starved
    finally:
        for p in (a, b):
            _close(p)


@pytest.mark.parametrize("bad", ["dtype", "shape", "strided"])
def test_read_into_out_checks_the_buffer(built, bad):
    p = pump.NativePump("wideband")
    try:
        out = {"dtype": torch.zeros((1, 8), dtype=torch.complex128),
               "shape": np.zeros((2, 8), np.complex64),
               "strided": np.zeros((1, 16), np.complex64)[:, ::2]}[bad]
        with pytest.raises((TypeError, ValueError)):
            p.read_samples(8, out=out)
    finally:
        _close(p)


def test_feed_push_into_on_cpu_equals_push():
    rng = np.random.default_rng(15)
    blocks = [rng.standard_normal((2, 64)).astype(np.complex64)
              for _ in range(5)]

    def step(s, x):
        s = s + x.sum()
        return s, x * 2.0 + s

    outs = []
    for into in (False, True):
        feed = DeviceFeed(step, torch.tensor(0j, dtype=torch.complex64),
                          prefetch=1, device="cpu")
        got = []
        for b in blocks:
            if into:
                got += feed.push_into(
                    b.shape, torch.complex64,
                    lambda buf, b=b: buf.copy_(torch.from_numpy(b)))
            else:
                got += feed.push(b)
        got += feed.flush()
        assert feed.staged_bytes == 0
        outs.append((got, feed.state))
    assert len(outs[0][0]) == len(outs[1][0]) == 5
    for x, y in zip(outs[0][0], outs[1][0]):
        assert torch.equal(x, y)
    assert torch.equal(outs[0][1], outs[1][1])


def test_feed_push_into_from_a_starved_pump_enqueues_nothing(built):
    p = pump.NativePump("wideband")
    feed = DeviceFeed(lambda s, x: (s, x), None, prefetch=0, device="cpu")
    try:
        assert feed.push_into((1, PKT), torch.complex64,
                              lambda buf: p.read_samples(PKT, out=buf)) \
            is None
        assert feed.flush() == []
        p.start()
        pkts, iq = _wideband_pkts(1, seed=16)
        _send(pkts, [p.local_addr], [p])
        (y,) = feed.push_into((1, PKT), torch.complex64,
                              lambda buf: p.read_samples(PKT, out=buf))
        np.testing.assert_array_equal(
            y.numpy()[0], native.unpack_iq24(pkts[0][8:]))
    finally:
        _close(p)


def test_wideband_plugin_reads_a_block_larger_than_the_default_ring(built):
    """A block of 160 packets (1 305 600 samples) is more than the default
    ring of 2^20 samples holds: with ``block`` the plugin sizes its ring
    to two blocks and returns it whole, through DeviceFeed.push_into."""
    n = 160 * PKT
    assert n > 1 << 20
    hw = get_hardware("wideband")(n_streams=1, sample_rate=196.608e6)
    hw.open()
    (addr,) = hw.start_pump(block=n)
    try:
        assert hw.pump.stats()["native"] is True
        pkts, _ = _wideband_pkts(160, seed=17, seq0=77)
        _send(pkts, [addr], [hw.pump], chunk=16)
        assert hw.pump.stats()["ring_overruns"] == 0
        feed = DeviceFeed(lambda s, x: (s, x), None, prefetch=0,
                          device="cpu")
        (blk,) = feed.push_into((1, n), torch.complex64,
                                lambda buf: hw.read_samples(n, out=buf))
        np.testing.assert_array_equal(
            blk.numpy()[0], native.unpack_iq24(b"".join(p[8:]
                                                         for p in pkts)))
        st = hw.pump.stats()
        assert st["seq_errors"] == 0 and st["fill"] == 0
    finally:
        hw.close()
