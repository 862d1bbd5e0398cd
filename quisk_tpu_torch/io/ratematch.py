"""Sample-rate matching between asynchronous clocks (host boundary).

Parity: the reference nulls the skew between capture and playback clocks
with a servo that watches the playback buffer fill over ~10 s and inserts/
drops interpolated samples (sound.c:504-618, esp. 534-549, 601-614); WDSP's
rmatch.c (737 LoC) does the same with a variable-ratio resampler.  The
device runs block-synchronously, so this lives at the host boundary: a
continuously-variable Lagrange resampler plus a proportional-integral servo
steering its ratio toward 50% buffer fill.

Host-side NumPy by design: the output sample count varies with the ratio
(a dynamic shape), and this sits on the ingest/playback path next to the
device feed, not on the card.
"""

from __future__ import annotations

import numpy as np


class VarRateResampler:
    """Continuously-variable-ratio 4-point Lagrange resampler (streaming).

    ``ratio`` = input_rate / output_rate; may change every block (that is
    the point).  Keeps a 4-sample history plus the fractional read phase.
    Parity: wdsp/varsamp.c / rmatch.c's interpolator, quisk.c:579 cFracDecim.
    """

    def __init__(self, ratio: float = 1.0, dtype=np.float64):
        self.ratio = float(ratio)
        # 4 history samples: the rebased phase stays >= 1 across blocks, so
        # the 4-point window [ip-1 .. ip+2] never indexes before the kept
        # history (output lags the input by 3 samples)
        self.hist = np.zeros(4, dtype)
        self.phase = 1.0
        self.dtype = dtype

    @staticmethod
    def _lagrange4(mu: np.ndarray) -> np.ndarray:
        """[n, 4] weights to interpolate at offset mu in [0,1) after x[1]."""
        m = mu[:, None]
        k = np.array([-1.0, 0.0, 1.0, 2.0])[None, :]
        w = np.ones((len(mu), 4))
        for j in range(4):
            for i in range(4):
                if i != j:
                    w[:, j] *= (m[:, 0] - k[0, i]) / (k[0, j] - k[0, i])
        return w

    def process(self, x: np.ndarray, ratio: float | None = None) -> np.ndarray:
        """Resample one block; returns however many outputs the ratio yields."""
        if ratio is not None:
            self.ratio = float(ratio)
        ext = np.concatenate([self.hist, np.asarray(x, self.dtype)])
        # read positions: phase, phase+ratio, ... while window fits;
        # position p uses ext[ip-1 .. ip+2] with ip = floor(p), relative to
        # the ext stream where index 4 is the first new sample => p is in
        # "ext samples" with 1 <= ip <= len(ext)-3
        n_max = int(np.floor(((len(ext) - 3) - self.phase) / self.ratio)) + 1
        if n_max <= 0:
            self.hist = ext[-4:]
            self.phase -= len(x)
            return np.zeros(0, self.dtype)
        p = self.phase + self.ratio * np.arange(n_max)
        ip = np.floor(p).astype(np.int64)
        mu = p - ip
        w = self._lagrange4(mu)
        win = ext[ip[:, None] + np.arange(-1, 3)[None, :]]
        y = np.sum(win * w, axis=1)
        self.phase = p[-1] + self.ratio - len(x)
        self.hist = ext[-4:]
        return y


class RateServo:
    """PI servo steering a VarRateResampler to hold a playback buffer at
    50% fill (parity sound.c:534-618 'sample-rate correction').

    feed() with each captured block; read() drains for the playback clock.
    The measured fill error adjusts the resample ratio by at most
    ``max_correction`` (the reference bounds its insert/drop rate too).
    """

    def __init__(self, buffer_samples: int, nominal_ratio: float = 1.0,
                 kp: float = 1e-4, ki: float = 2e-6,
                 max_correction: float = 5e-3, dtype=np.float64):
        self.rs = VarRateResampler(nominal_ratio, dtype)
        self.nominal = float(nominal_ratio)
        self.size = int(buffer_samples)
        self.buf = np.zeros(0, dtype)
        self.kp, self.ki = kp, ki
        self.integ = 0.0
        self.max_corr = max_correction
        self.underruns = 0
        self.overruns = 0

    @property
    def fill(self) -> float:
        return len(self.buf) / self.size

    def feed(self, x: np.ndarray) -> None:
        err = self.fill - 0.5
        self.integ = np.clip(self.integ + err, -200.0, 200.0)
        corr = np.clip(self.kp * err + self.ki * self.integ,
                       -self.max_corr, self.max_corr)
        # buffer too full -> consume captured samples faster (ratio up)
        y = self.rs.process(x, self.nominal * (1.0 + corr))
        self.buf = np.concatenate([self.buf, y])
        if len(self.buf) > self.size:
            self.overruns += 1
            self.buf = self.buf[len(self.buf) - self.size:]

    def read(self, n: int) -> np.ndarray:
        if len(self.buf) < n:
            self.underruns += 1
            out = np.concatenate([self.buf, np.zeros(n - len(self.buf),
                                                     self.buf.dtype)])
            self.buf = self.buf[:0]
            return out
        out, self.buf = self.buf[:n], self.buf[n:]
        return out
