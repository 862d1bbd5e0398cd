"""Extra CAT control surfaces beyond ``rigctld``.

Parity with the reference's three remaining CAT paths:

- :class:`FlexZZProtocol` / :class:`SerialCat` — the Kenwood-TS2000 /
  FlexRadio-PowerSDR "ZZ" command set over a pseudo-tty
  (quisk.py:286 ``HamlibHandlerSerial``): loggers and N1MM+ style
  programs open a serial port and speak ``ZZFA00007074000;``.
- :class:`K4Protocol` / :class:`K4Server` — the Elecraft K4 command set
  over TCP (quisk.py:1256 ``ElecraftK4Handler``, default port 9200),
  used by K4-aware clients (Win4K4, remote heads).
- :func:`wsjtx_command` / :func:`start_wsjtx` — the WSJT-X launcher
  (quisk.py:4380 ``StartWsjtx``): build the argv from settings and spawn
  the process when the configured binary exists.

All handlers drive the same :class:`quisk_tpu_torch.app.rigctl.RadioState`
that rigctld uses, so every CAT client (NET rigctl, serial ZZ, K4 TCP)
sees and mutates one consistent radio.  The command *vocabularies*
(digit counts, mode code tables, IF-response layout) are the wire
protocol of the emulated radios and therefore match the reference; the
dispatch here is table-driven rather than a method per command.
"""

from __future__ import annotations

import os
import select
import shutil
import socketserver
import subprocess
import threading

from quisk_tpu_torch.app.rigctl import RadioState

# Kenwood TS-2000 and Flex PowerSDR mode codes (the emulated radios'
# vocabularies — k5fr.com CAT reference; quisk.py:295-298)
KENWOOD_CODE = {"CWL": 7, "CWU": 3, "LSB": 1, "USB": 2, "AM": 5, "FM": 4,
                "DGT_U": 9, "FDV_U": 9, "DGT_L": 6, "FDV_L": 6,
                "DGT_FM": 4, "DGT_IQ": 9, "DGT_FDV": 9}
KENWOOD_MODE = {1: "LSB", 2: "USB", 3: "CWU", 4: "FM", 5: "AM",
                6: "DGT_L", 7: "CWL", 9: "DGT_U"}
FLEX_CODE = {"CWL": 3, "CWU": 4, "LSB": 0, "USB": 1, "AM": 6, "FM": 5,
             "DGT_U": 7, "FDV_U": 7, "DGT_L": 9, "FDV_L": 9,
             "DGT_FM": 5, "DGT_IQ": 7, "DGT_FDV": 7}
FLEX_MODE = {0: "LSB", 1: "USB", 3: "CWL", 4: "CWU", 5: "FM", 6: "AM",
             7: "DGT_U", 9: "DGT_L"}
ELECRAFT_CODE = {"LSB": 1, "USB": 2, "CWU": 3, "FM": 4, "AM": 5,
                 "DGT_U": 6, "CWL": 7, "DGT_L": 9, "DGT_FM": 4,
                 "DGT_IQ": 6, "DGT_FDV": 6}
ELECRAFT_MODE = {1: "LSB", 2: "USB", 3: "CWU", 4: "FM", 5: "AM",
                 6: "DGT_U", 7: "CWL", 9: "DGT_L"}

# ZZAC parameter <-> tune step in Hz (quisk.py:299-328)
_ZZAC_STEPS = (1, 10, 50, 100, 250, 500, 1000, 5000, 9000, 10000,
               100000, 250000, 500000, 1000000, 10000000)


def _ensure_extras(st: RadioState) -> None:
    """Fields the ZZ set controls beyond the rigctl core."""
    for field, default in (("volume", 1.0), ("agc_level", 500),
                           ("band", "40"), ("vox", False), ("rit", 0),
                           ("rit_on", False)):
        if not hasattr(st, field):
            setattr(st, field, default)


class FlexZZProtocol:
    """Stateful command interpreter for the Flex/Kenwood serial set.

    ``handle(cmd)`` consumes one ';'-stripped command and returns the
    response text ('' for set-commands, which reply nothing —
    quisk.py:444-727).  ``smeter`` is a callable returning dBm-ish
    strength (the rigctl ``hamlib_strength`` analogue, S9 = -73).
    """

    def __init__(self, state: RadioState | None = None, smeter=None):
        self.state = state or RadioState()
        _ensure_extras(self.state)
        self.smeter = smeter or (lambda: -73.0)
        self.radio_id = "019"
        self.tune_step = 1000

    # -- the wire loop -----------------------------------------------------
    def feed(self, text: str) -> str:
        """Append raw characters; returns concatenated responses for every
        complete ';'-terminated command found."""
        self._rxbuf = getattr(self, "_rxbuf", "") + text
        out = []
        while ";" in self._rxbuf:
            cmd, _, self._rxbuf = self._rxbuf.partition(";")
            cmd = cmd.strip()
            if cmd:
                out.append(self.handle(cmd))
        return "".join(out)

    def handle(self, cmd: str) -> str:
        # 4-letter ZZxx commands vs 2-letter Kenwood commands; FA/FB/IF/PS
        # share the ZZ implementation (quisk.py:404-416)
        if cmd[:2].upper() == "ZZ":
            name, data = cmd[:4].upper(), cmd[4:]
            fn_name = name
        else:
            name, data = cmd[:2].upper(), cmd[2:]
            # FA/FB/IF/PS share the ZZ implementation but echo the short
            # name in replies (quisk.py:404-416 keeps cmd 2-letter)
            fn_name = "ZZ" + name if name in ("FA", "FB", "IF", "PS") \
                else name
        fn = getattr(self, "_" + fn_name, None)
        if fn is None:
            return "?;"
        try:
            return fn(name, data)
        except (ValueError, KeyError, IndexError):
            return "?;"

    # -- helpers -----------------------------------------------------------
    def _freq(self, tx=False):
        return self.state.tx_freq if tx else self.state.freq

    def _set_freq(self, freq, tx=False):
        self.state.set("tx_freq" if tx else "freq", int(freq))

    # -- frequency / tuning ------------------------------------------------
    def _ZZFA(self, n, d):                 # VFO A = receive frequency
        if not d:
            return "%s%011d;" % (n, self._freq())
        self._set_freq(int(d))
        return ""

    def _ZZFB(self, n, d):                 # VFO B = transmit frequency
        if not d:
            return "%s%011d;" % (n, self._freq(tx=True))
        self._set_freq(int(d), tx=True)
        return ""

    def _ZZAC(self, n, d):                 # tune step get/set
        if not d:
            return "%s%02d;" % (n, _ZZAC_STEPS.index(self.tune_step))
        self.tune_step = _ZZAC_STEPS[int(d)]
        return ""

    def _ZZAD(self, n, d):                 # VFO A down one step
        self._set_freq(self._freq() - self.tune_step)
        return ""

    def _ZZAU(self, n, d):                 # VFO A up one step
        self._set_freq(self._freq() + self.tune_step)
        return ""

    def _ZZBS(self, n, d):                 # band switch
        if not d:
            band = self.state.band
            return ("%s%03d;" % (n, int(band))
                    if band.isdigit() else "%s888;" % n)
        self.state.set("band", d.lstrip("0") or "0")
        return ""

    # -- mode --------------------------------------------------------------
    def _MD(self, n, d):                   # Kenwood mode code
        if not d:
            return "%s%d;" % (n, KENWOOD_CODE.get(self.state.mode, 2))
        self.state.set("mode", KENWOOD_MODE.get(int(d), "USB"))
        return ""

    def _ZZMD(self, n, d):                 # Flex mode code
        if not d:
            return "%s%02d;" % (n, FLEX_CODE.get(self.state.mode, 1))
        self.state.set("mode", FLEX_MODE.get(int(d), "USB"))
        return ""

    # -- info block (quisk.py:579-620) --------------------------------------
    def _ZZIF(self, n, d):
        st = self.state
        flex = len(n) == 4
        rit = st.rit
        info = [n, "%011d" % self._freq()]
        if flex:
            info += ["0000", "%+06d" % rit]
        else:
            info += ["00000", "%+05d" % rit]
        info += ["1" if st.rit_on else "0", "0000",
                 "1" if st.ptt else "0"]
        if flex:
            info.append("%02d" % FLEX_CODE.get(st.mode, 1))
        else:
            info.append("%d" % KENWOOD_CODE.get(st.mode, 1))
        info += ["00", "1" if st.split else "0", "0000;"]
        return "".join(info)

    def _OI(self, n, d):
        return self._ZZIF(n, d)

    # -- audio / AGC -------------------------------------------------------
    def _AG(self, n, d):
        return "%s%s120;" % (n, d[0]) if d else "?;"

    def _ZZAG(self, n, d):                 # audio gain 0-100
        if not d:
            return "%s%03d;" % (n, round(self.state.volume * 100))
        self.state.set("volume", min(int(d), 100) / 100.0)
        return ""

    def _ZZAR(self, n, d):                 # AGC level -20..120 <-> 0..1000
        if not d:
            v = self.state.agc_level * 140 // 1000 - 20
            return "%s%+04d;" % (n, v)
        self.state.set("agc_level", (int(d) + 20) * 1000 // 140)
        return ""

    # -- PTT / VOX ---------------------------------------------------------
    def _TX(self, n, d):
        self.state.set("ptt", True)
        return ""

    def _RX(self, n, d):
        self.state.set("ptt", False)
        return ""

    def _ZZTX(self, n, d):
        if not d:
            return "%s%d;" % (n, 1 if self.state.ptt else 0)
        self.state.set("ptt", d[0] != "0")
        return ""

    def _ZZVE(self, n, d):
        return "%s%d;" % (n, 1 if self.state.vox else 0)

    # -- status / identity -------------------------------------------------
    def _ID(self, n, d):
        return "%s%s;" % (n, self.radio_id)

    def _ZZID(self, n, d):                 # switch identity to Flex
        self.radio_id = "900"
        return ""

    def _ZZPS(self, n, d):                 # power status: always on
        return "%s1;" % n

    def _ZZMU(self, n, d):                 # MultiRx off
        return "%s0;" % n

    def _ZZRS(self, n, d):                 # RX2 absent
        return "%s0;" % n if not d else ""

    def _ZZAI(self, n, d):                 # broadcast-changes off
        return "%s0;" % n if not d else ""

    def _ZZSM(self, n, d):                 # S-meter, dB*2 in [0, 260]
        i = min(max(round((self.smeter() + 140) * 2), 0), 260)
        return "%s%03d;" % (n, i)

    def _ZZSP(self, n, d):                 # split on/off
        if not d:
            return "%s%d;" % (n, 1 if self.state.split else 0)
        self.state.set("split", d[0] == "1")
        return ""

    def _ZZSW(self, n, d):                 # TX VFO is B when split
        return self._ZZSP(n, d)

    def _FR(self, n, d):                   # receive VFO is always A
        return "%s0;" % n if not d else ""

    def _FT(self, n, d):                   # transmit VFO (FT1 = split: TX
        if not d:                          # on VFO B, Kenwood TS-2000)
            return "%s%d;" % (n, 1 if self.state.split else 0)
        self.state.set("split", d[0] == "1")
        return ""

    # -- RIT (Kenwood RT/RU/RD/RC; reported in the IF block like
    # quisk.py:580-600 reads ritScale/ritButton) ----------------------------
    def _RT(self, n, d):                   # RIT on/off
        if not d:
            return "%s%d;" % (n, 1 if self.state.rit_on else 0)
        self.state.set("rit_on", d[0] == "1")
        return ""

    def _RU(self, n, d):                   # RIT up (RUnnnn or 10 Hz step)
        self.state.set("rit", self.state.rit + (int(d) if d else 10))
        return ""

    def _RD(self, n, d):                   # RIT down
        self.state.set("rit", self.state.rit - (int(d) if d else 10))
        return ""

    def _RC(self, n, d):                   # RIT clear
        self.state.set("rit", 0)
        return ""

    def _XT(self, n, d):                   # no XIT
        return "%s0;" % n if not d else ""


class SerialCat:
    """Pseudo-tty wrapper: creates a pty, symlinks the slave at
    ``public_name`` (quisk.py:360-384), and pumps bytes through a
    :class:`FlexZZProtocol` on each :meth:`process` call (the reference
    polls from its main loop)."""

    def __init__(self, public_name: str, state: RadioState | None = None,
                 smeter=None):
        import tty

        self.proto = FlexZZProtocol(state, smeter)
        self.public_name = public_name
        self.master, slave = os.openpty()
        tty.setraw(self.master)
        tty.setraw(slave)
        self.slave_name = os.ttyname(slave)
        if public_name:
            if os.path.lexists(public_name):
                os.remove(public_name)
            os.symlink(self.slave_name, public_name)

    @property
    def state(self) -> RadioState:
        return self.proto.state

    def process(self) -> None:
        """Drain pending serial bytes and write any responses."""
        while True:
            r, _, _ = select.select((self.master,), (), (), 0)
            if not r:
                return
            try:
                data = os.read(self.master, 4096)
            except OSError:
                return
            if not data:
                return
            out = self.proto.feed(data.decode(errors="replace"))
            if out:
                _, w, _ = select.select((), (self.master,), (), 0.2)
                if w:
                    os.write(self.master, out.encode())

    def close(self) -> None:
        try:
            os.close(self.master)
        except OSError:
            pass
        if self.public_name and os.path.lexists(self.public_name):
            os.remove(self.public_name)


# ---------------------------------------------------------------- K4 TCP
class K4Protocol:
    """Elecraft K4 command interpreter (quisk.py:1256-1480).  Unknown
    commands answer ``XX?;`` like the radio does."""

    def __init__(self, state: RadioState | None = None, smeter=None,
                 cw_pitch: float = 600.0):
        self.state = state or RadioState()
        _ensure_extras(self.state)
        self.smeter = smeter or (lambda: -73.0)
        self.cw_pitch = cw_pitch
        self.k31 = False

    def feed(self, text: str) -> str:
        self._rxbuf = getattr(self, "_rxbuf", "") + text
        out = []
        while ";" in self._rxbuf:
            cmd, _, self._rxbuf = self._rxbuf.partition(";")
            cmd = cmd.strip()
            if len(cmd) >= 2:
                out.append(self.handle(cmd))
        return "".join(out)

    def handle(self, cmd: str) -> str:
        base, args = cmd[:2].upper(), cmd[2:]
        if args[:1] == "$":                # sub-receiver form FA$ etc.
            base, args = base + "$", args[1:]
        fn = getattr(self, "_" + base.rstrip("$"), None)
        if fn is None:
            return cmd[:2] + "?;"
        try:
            return fn(base, args)
        except (ValueError, KeyError, IndexError):
            return base[:2] + "?;"

    def _AI(self, b, a):                   # auto-info: always off
        return "AI0;" if (not a or a != "0") else ""

    def _CW(self, b, a):                   # CW pitch in tens of Hz, 25-95
        return "CW%d;" % min(max(round(self.cw_pitch / 10), 25), 95)

    def _DT(self, b, a):
        return "%s0;" % b

    def _ID(self, b, a):
        return "ID?;" if a else "ID017;"

    def _FA(self, b, a):
        return self._vfo(b, a, tx=False)

    def _FB(self, b, a):
        return self._vfo(b, a, tx=True)

    def _vfo(self, b, a, tx):
        if not a:
            freq = self.state.tx_freq if tx else self.state.freq
            return "%s%011d;" % (b, freq)
        freq = int(a)
        # short forms scale: <=2 digits MHz, <=5 digits kHz (quisk.py:1409)
        if len(a) <= 2:
            freq *= 1000000
        elif len(a) <= 5:
            freq *= 1000
        self.state.set("tx_freq" if tx else "freq", freq)
        return ""

    def _FT(self, b, a):
        if not a:
            return "FT%d;" % (1 if self.state.split else 0)
        self.state.set("split", a != "0")
        return ""

    def _FW(self, b, a):                   # filter bandwidth in tens of Hz
        if not a:
            return "%s%04d;" % (b, (self.state.passband + 5) // 10)
        self.state.set("passband", int(a) * 10)
        return ""

    def _IS(self, b, a):                   # IF center = half the passband
        code = self.state.passband // 2
        if not a:
            if self.k31:
                return "%s %04d;" % (b, code)
            return "%s%04d;" % (b, (code + 5) // 10)
        self.state.set("passband",
                       int(a) * 2 if self.k31 else int(a) * 20)
        return ""

    def _IF(self, b, a):                   # info block (quisk.py:1366-1390)
        st = self.state
        info = ["%011d     " % st.freq, "%+05d" % st.rit,
                "10 00" if st.rit_on else "00 00",
                "1" if st.ptt else "0",
                "%d" % ELECRAFT_CODE.get(st.mode, 2), "00",
                "1" if st.split else "0", "001 ;"]
        return "".join(info)

    def _K3(self, b, a):
        self.k31 = a == "1"
        return ""

    def _KS(self, b, a):
        return "KS013;" if not a else ""

    def _LN(self, b, a):
        return "LN0;" if a != "0" else ""

    def _MD(self, b, a):
        if not a:
            return "%s%d;" % (b, ELECRAFT_CODE.get(self.state.mode, 2))
        self.state.set("mode", ELECRAFT_MODE[int(a)])
        return ""

    def _OM(self, b, a):
        return "OM ------------;"

    def _RV(self, b, a):
        return "%s99.99;" % b

    def _RX(self, b, a):
        self.state.set("ptt", False)
        return ""

    def _TX(self, b, a):
        self.state.set("ptt", True)
        return ""

    def _SB(self, b, a):
        return "SB0;"

    def _SM(self, b, a):
        if a:
            return b + "?;"
        return "SM0000;" if self.k31 else "SM00;"


class _K4Handler(socketserver.StreamRequestHandler):
    def handle(self):
        proto = K4Protocol(self.server.state, self.server.smeter,
                           self.server.cw_pitch)
        while True:
            try:
                data = self.request.recv(1024)
            except OSError:
                return
            if not data:
                return
            out = proto.feed(data.decode(errors="replace"))
            if out:
                try:
                    self.wfile.write(out.encode())
                except OSError:
                    return


class K4Server:
    """Threaded Elecraft-K4 TCP server (reference default port 9200)."""

    def __init__(self, state: RadioState | None = None, port: int = 9200,
                 host: str = "127.0.0.1", smeter=None,
                 cw_pitch: float = 600.0):
        self.state = state or RadioState()
        _ensure_extras(self.state)
        self._srv = socketserver.ThreadingTCPServer(
            (host, port), _K4Handler, bind_and_activate=False)
        self._srv.allow_reuse_address = True
        self._srv.daemon_threads = True
        self._srv.state = self.state
        self._srv.smeter = smeter or (lambda: -73.0)
        self._srv.cw_pitch = cw_pitch
        self.port = port

    def start(self) -> int:
        self._srv.server_bind()
        self._srv.server_activate()
        self.port = self._srv.server_address[1]
        threading.Thread(target=self._srv.serve_forever, daemon=True).start()
        return self.port

    def stop(self) -> None:
        self._srv.shutdown()
        self._srv.server_close()


# ------------------------------------------------------------- WSJT-X glue
def wsjtx_command(globals_cfg: dict | None = None) -> list[str] | None:
    """Build the WSJT-X argv from the settings globals (quisk.py:4380
    ``StartWsjtx``): ``path_to_wsjtx``, ``config_wsjtx``,
    ``rig_name_wsjtx``.  Returns None when the binary doesn't exist."""
    g = globals_cfg or {}
    path = g.get("path_to_wsjtx", "") or shutil.which("wsjtx") \
        or "/usr/bin/wsjtx"
    if not os.path.isfile(path):
        return None
    prog = [path, "--rig-name", g.get("rig_name_wsjtx", "quisk")]
    cfg = g.get("config_wsjtx", "")
    if cfg:
        prog += ["--config", cfg]
    return prog


def start_wsjtx(globals_cfg: dict | None = None):
    """Spawn WSJT-X if configured and present; returns the Popen or None."""
    prog = wsjtx_command(globals_cfg)
    if prog is None:
        return None
    return subprocess.Popen(prog, shell=False)
