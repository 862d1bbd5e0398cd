"""Filter design — host-side, float64 NumPy.

The port's own copy of the receive chain's design functions, so that the
package never imports the JAX package.  Taps are bit-identical to
``quisk_tpu.ops.design`` (asserted by tests/test_torch_host.py).  Designs
run once at configuration time; the resulting taps and masks are data on
the device, so retuning a filter is a tensor swap.

Functional parity targets in the reference:
- windowed-sinc lowpass design: quisk.py:5405 ``MakeFilterCoef``
- analytic tuning of a real lowpass into a complex bandpass:
  filter.c:58-81 ``quisk_filt_tune``
- 45-tap half-band decimate-by-2 with ~120 dB stopband: filter.c:377-417
"""

from __future__ import annotations

import functools

import numpy as np
from scipy import signal as _sig


def lowpass(ntaps: int, cutoff_hz: float, fs: float,
            window: str | tuple = "blackman") -> np.ndarray:
    """Windowed-sinc FIR lowpass, unity DC gain, float64 taps."""
    if ntaps % 2 == 0:
        ntaps += 1
    return _sig.firwin(ntaps, cutoff_hz, fs=fs, window=window)


def tune(taps: np.ndarray, center_hz: float, fs: float) -> np.ndarray:
    """Shift a filter's response by +center_hz (tap k times
    e^{j 2 pi f (k - D) / fs}, D = (T-1)/2, filter.c:58-81)."""
    t = np.asarray(taps)
    k = np.arange(len(t), dtype=np.float64) - (len(t) - 1) / 2.0
    return t * np.exp(2j * np.pi * center_hz * k / fs)


def bandpass_analytic(ntaps: int, f1: float, f2: float, fs: float,
                      window: str | tuple = "blackman") -> np.ndarray:
    """Complex analytic bandpass passing [f1, f2] (may be negative for LSB).

    The RX channel filter: it bandlimits and selects the sideband, so SSB
    demodulation after it is taking the real part.
    """
    if f2 <= f1:
        raise ValueError(f"need f1 < f2, got [{f1}, {f2}]")
    half_bw = (f2 - f1) / 2.0
    center = (f1 + f2) / 2.0
    lp = lowpass(ntaps, half_bw, fs, window)
    return tune(lp, center, fs)


def bandpass_with_notches(ntaps: int, f1: float, f2: float, fs: float,
                          notches=(), window: str | tuple = "blackman"
                          ) -> np.ndarray:
    """Analytic bandpass with narrow ``(center_hz, width_hz)`` notches
    carved out of the passband (wdsp/nbp.c notch-bank bandpass): each
    in-band notch subtracts an aligned narrow analytic bandpass; notches
    outside the passband are skipped."""
    h = bandpass_analytic(ntaps, f1, f2, fs, window)
    for fc, width in notches:
        lo = max(f1, fc - width / 2.0)
        hi = min(f2, fc + width / 2.0)
        if hi - lo < 1e-9:
            continue                     # entirely out of band
        h = h - bandpass_analytic(ntaps, lo, hi, fs, window)
    return h


def kaiser_beta(atten_db: float) -> float:
    return float(_sig.kaiser_beta(atten_db))


@functools.lru_cache(maxsize=None)
def halfband(ntaps: int = 45, atten_db: float = 120.0) -> np.ndarray:
    """Half-band lowpass for decimate-by-2 (filter.c:379-385 HB45).

    Every even-offset tap except the center is exactly zero.  Float64 taps,
    unity DC gain.  Cached: treat the result as read-only.
    """
    if ntaps % 4 != 1:
        raise ValueError("half-band FIR needs ntaps % 4 == 1 (e.g. 45)")
    beta = kaiser_beta(atten_db)
    h = _sig.firwin(ntaps, 0.5, window=("kaiser", beta))
    k = np.arange(ntaps) - (ntaps - 1) // 2
    h[(k % 2 == 0) & (k != 0)] = 0.0
    return h / h.sum()


def decimator(decim: int, fs_in: float, atten_db: float = 100.0,
              passband_frac: float = 0.4) -> np.ndarray:
    """Anti-alias lowpass for an integer decimator stage: passband edge at
    ``passband_frac * fs_out``, stopband edge at ``fs_out / 2``."""
    fs_out = fs_in / decim
    cutoff = passband_frac * fs_out
    transition = (0.5 - passband_frac) * fs_out
    ntaps, beta = _sig.kaiserord(atten_db, transition / (0.5 * fs_in))
    ntaps |= 1
    return _sig.firwin(ntaps, cutoff + transition / 2.0, fs=fs_in,
                       window=("kaiser", beta))
