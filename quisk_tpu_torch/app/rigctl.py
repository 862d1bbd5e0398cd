"""Hamlib ``rigctld`` protocol server: external programs (WSJT-X, fldigi,
loggers) control the radio over TCP.

Parity: the reference embeds two Hamlib handlers — a serial Flex-style one
(quisk.py:286) and the rigctld network protocol (HamlibHandlerRig2,
quisk.py:720) used by WSJT-X via "Hamlib NET rigctl".  This implements the
same wire protocol subset those clients use: F/f (frequency), M/m (mode +
passband), T/t (PTT), V/v (VFO), S/s (split), \\dump_state, \\chk_vfo,
q/Q (quit), with both the single-letter and long ("\\set_freq") forms and
the extended-response ("+F 14000000") syntax.
"""

from __future__ import annotations

import socketserver
import threading

HAMLIB_MODES = ("USB", "LSB", "CW", "CWR", "AM", "FM", "DIGU", "DIGL")

# quisk<->hamlib mode vocabulary (the reference maps CWU/CWL <-> CW/CWR,
# DGT_* <-> DIGU/DIGL)
TO_HAMLIB = {"CWU": "CW", "CWL": "CWR", "DGT_U": "DIGU", "DGT_L": "DIGL",
             "DGT_IQ": "DIGU", "DGT_FDV": "DIGU", "FDV_U": "DIGU",
             "FDV_L": "DIGL"}
FROM_HAMLIB = {"CW": "CWU", "CWR": "CWL", "DIGU": "DGT_U", "DIGL": "DGT_L",
               "PKTUSB": "DGT_U", "PKTLSB": "DGT_L"}


class RadioState:
    """The controllable state (the app wires these to the running chains)."""

    def __init__(self):
        self.freq = 7_050_000
        self.mode = "USB"
        self.passband = 2800
        self.ptt = False
        self.vfo = "VFOA"
        self.split = False
        self.tx_freq = 7_050_000
        self.lock = threading.Lock()
        self.on_change = None          # callback(field, value)

    def set(self, field, value):
        with self.lock:
            setattr(self, field, value)
        if self.on_change:
            self.on_change(field, value)


# 2 = protocol version; rig model 2 = NET rigctl; the long bitmasks cover
# the modes above on all bands (what WSJT-X checks for capability)
_DUMP_STATE = (
    "0\n2\n2\n150000.000000 1500000000.000000 0x1ff -1 -1 0x10000003 0x3\n"
    "0 0 0 0 0 0 0\n"
    "150000.000000 1500000000.000000 0x1ff -1 -1 0x10000003 0x3\n"
    "0 0 0 0 0 0 0\n"
    "0 0\n0 0\n0\n0\n0\n0\n\n\n0x0\n0x0\n0x0\n0x0\n0x0\n0\n")


class _Handler(socketserver.StreamRequestHandler):
    def handle(self):
        st: RadioState = self.server.state
        while True:
            line = self.rfile.readline()
            if not line:
                return
            line = line.decode("ascii", "replace").strip()
            if not line:
                continue
            for out in self._dispatch(st, line):
                self.wfile.write(out.encode("ascii"))
            if line in ("q", "Q", "\\quit"):
                return

    def _dispatch(self, st, line):
        ext = line.startswith("+")
        if ext:
            line = line[1:]
        parts = line.split()
        cmd, args = parts[0], parts[1:]
        long_to_short = {
            "\\set_freq": "F", "\\get_freq": "f", "\\set_mode": "M",
            "\\get_mode": "m", "\\set_ptt": "T", "\\get_ptt": "t",
            "\\set_vfo": "V", "\\get_vfo": "v", "\\set_split_vfo": "S",
            "\\get_split_vfo": "s", "\\set_split_freq": "I",
            "\\get_split_freq": "i", "\\dump_state": "\\dump_state",
            "\\chk_vfo": "\\chk_vfo", "\\quit": "q",
        }
        cmd = long_to_short.get(cmd, cmd)

        def reply(body="", code=0, echo=""):
            if ext:
                return [f"{echo}:\n{body}RPRT {code}\n" if body or code == 0
                        else f"RPRT {code}\n"]
            if body:
                return [body]
            return [f"RPRT {code}\n"]

        if cmd == "\\dump_state":
            return [_DUMP_STATE]
        if cmd == "\\chk_vfo":
            return ["0\n"]
        if cmd == "F":
            st.set("freq", int(float(args[0])))
            return reply(echo=f"set_freq {args[0]}")
        if cmd == "f":
            return reply(f"{st.freq}\n", echo="get_freq")
        if cmd == "M":
            mode = FROM_HAMLIB.get(args[0], args[0])
            st.set("mode", mode)
            if len(args) > 1 and int(float(args[1])) > 0:
                st.set("passband", int(float(args[1])))
            return reply(echo=f"set_mode {' '.join(args)}")
        if cmd == "m":
            hmode = TO_HAMLIB.get(st.mode, st.mode)
            return reply(f"{hmode}\n{st.passband}\n", echo="get_mode")
        if cmd == "T":
            st.set("ptt", args[0] not in ("0",))
            return reply(echo=f"set_ptt {args[0]}")
        if cmd == "t":
            return reply(f"{1 if st.ptt else 0}\n", echo="get_ptt")
        if cmd == "V":
            st.set("vfo", args[0])
            return reply(echo=f"set_vfo {args[0]}")
        if cmd == "v":
            return reply(f"{st.vfo}\n", echo="get_vfo")
        if cmd == "S":
            st.set("split", args[0] not in ("0",))
            if len(args) > 1:
                st.set("vfo", args[1])
            return reply(echo=f"set_split_vfo {' '.join(args)}")
        if cmd == "s":
            return reply(f"{1 if st.split else 0}\n{st.vfo}\n",
                         echo="get_split_vfo")
        if cmd == "I":
            st.set("tx_freq", int(float(args[0])))
            return reply(echo=f"set_split_freq {args[0]}")
        if cmd == "i":
            return reply(f"{st.tx_freq}\n", echo="get_split_freq")
        if cmd in ("q", "Q"):
            return []
        return reply(code=-11)        # RIG_ENAVAIL: command not available


class RigctlServer:
    """Threaded TCP server; start()/stop(); state shared with the app."""

    def __init__(self, state: RadioState | None = None,
                 host: str = "127.0.0.1", port: int = 4532):
        self.state = state or RadioState()
        self._srv = socketserver.ThreadingTCPServer(
            (host, port), _Handler, bind_and_activate=False)
        self._srv.allow_reuse_address = True
        self._srv.daemon_threads = True
        self._srv.state = self.state
        self._thread = None
        self.host, self.port = host, port

    def start(self) -> int:
        self._srv.server_bind()
        self._srv.server_activate()
        self.port = self._srv.server_address[1]
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self.port

    def stop(self) -> None:
        self._srv.shutdown()
        self._srv.server_close()
