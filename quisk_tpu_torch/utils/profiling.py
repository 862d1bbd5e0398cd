"""Timing instrumentation (parity: utility.c QuiskTimeSec / QuiskDeltaSec /
QuiskPrintTime chains around hot-loop stages, and QuiskMeasureRate for
actual device sample rates).

Counterpart of ``quisk_tpu.utils.profiling``.  ``StageTimer`` wraps the
block loop the way the reference sprinkles ``QuiskPrintTime(msg, idx)``
through quisk_read_sound (sound.c:904-1189); ``RateMeter`` measures the
achieved samples/s of any streaming boundary.  PyTorch returns before the
card finishes, so a mark given the stage's CUDA output synchronises that
device first: enable timers only when profiling.
"""

from __future__ import annotations

import time
from collections import defaultdict

import torch


class StageTimer:
    """Accumulates wall time between named marks across many blocks.

    >>> tm = StageTimer(enabled=True)
    >>> tm.start(); y = work(); tm.mark("decimate", y)
    >>> print(tm.report())
    """

    def __init__(self, enabled: bool = True, sync: bool = True):
        self.enabled = enabled
        self.sync = sync
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self._t = None

    def start(self) -> None:
        if self.enabled:
            self._t = time.perf_counter()

    def mark(self, name: str, value=None) -> None:
        """Close the interval since the last mark/start under ``name``.
        Pass the stage's output tensor as ``value`` to time it honestly:
        a CUDA tensor synchronises its device first."""
        if not self.enabled or self._t is None:
            return
        if (value is not None and self.sync
                and isinstance(value, torch.Tensor)
                and value.device.type == "cuda"):
            torch.cuda.synchronize(value.device)
        now = time.perf_counter()
        self.totals[name] += now - self._t
        self.counts[name] += 1
        self._t = now

    def report(self) -> str:
        lines = []
        for name, tot in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name:24s} {tot * 1e3:9.2f} ms total  "
                         f"{tot / n * 1e3:8.3f} ms/block  ({n} blocks)")
        return "\n".join(lines)

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()


class RateMeter:
    """Measured samples/s of a streaming boundary (parity utility.c:238
    QuiskMeasureRate: the reference shows actual vs nominal device rates).
    """

    def __init__(self, window_secs: float = 2.0):
        self.window = window_secs
        self._t0 = None
        self._n = 0
        self.rate = 0.0

    def add(self, n_samples: int) -> float:
        now = time.monotonic()
        if self._t0 is None:
            self._t0 = now
            self._n = 0
            return self.rate
        self._n += n_samples
        dt = now - self._t0
        if dt >= self.window:
            self.rate = self._n / dt
            self._t0 = now
            self._n = 0
        return self.rate
