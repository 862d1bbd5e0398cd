"""Unified status/error counters (parity: QS.get_state quisk.c:2744 and
QS.sound_errors sound.c:1658 — the reference surfaces read/write/underrun
errors, latency and fill levels on its Config/Status screen).

Components register themselves (or are polled via duck-typed attributes:
``underruns``, ``overruns``, ``lost``, ``fill``, ``overrun_count``);
:meth:`snapshot` returns one flat dict for any frontend or log line.
"""

from __future__ import annotations

import time
from typing import Any

_POLL_ATTRS = ("underruns", "overruns", "lost", "fill", "fft_errors",
               "read_errors", "write_errors")


class StatusBoard:
    def __init__(self):
        self._sources: dict[str, Any] = {}
        self._counters: dict[str, int] = {}
        self._started = time.monotonic()

    def attach(self, name: str, obj: Any) -> None:
        """Register a component exposing counter attributes/methods."""
        self._sources[name] = obj

    def count(self, name: str, inc: int = 1) -> None:
        """Direct counter bump (e.g. 'fft_overrun' — quisk.c:2471)."""
        self._counters[name] = self._counters.get(name, 0) + inc

    def snapshot(self) -> dict[str, Any]:
        out: dict[str, Any] = {
            "uptime_secs": round(time.monotonic() - self._started, 1)}
        out.update(self._counters)
        for name, obj in self._sources.items():
            for attr in _POLL_ATTRS:
                v = getattr(obj, attr, None)
                if callable(v):
                    v = v()
                if v is not None:
                    out[f"{name}.{attr}"] = v
            if hasattr(obj, "overrun_count"):
                out[f"{name}.overruns"] = obj.overrun_count()
        return out

    def healthy(self, limits: dict[str, float] | None = None) -> bool:
        """True when no counter exceeds its limit (default: any error > 0
        still counts as healthy — limits express the tolerance)."""
        limits = limits or {}
        snap = self.snapshot()
        for key, lim in limits.items():
            if snap.get(key, 0) > lim:
                return False
        return True
