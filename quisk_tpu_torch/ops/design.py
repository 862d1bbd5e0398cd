"""Filter design — host-side, float64 NumPy.

The port's own copy of the design functions, so that the
package never imports the JAX package.  Taps are bit-identical to
``quisk_tpu.ops.design`` (asserted by tests/test_torch_host.py).  Designs
run once at configuration time; the resulting taps and masks are data on
the device, so retuning a filter is a tensor swap.

Functional parity targets in the reference:
- windowed-sinc lowpass design: quisk.py:5405 ``MakeFilterCoef``
- analytic tuning of a real lowpass into a complex bandpass:
  filter.c:58-81 ``quisk_filt_tune``
- 45-tap half-band decimate-by-2 with ~120 dB stopband: filter.c:377-417
- equiripple bandpass: the premade sets of filters.py, by remez at runtime
- CIC droop compensation: wdsp/icfir.c
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


def kaiser_lowpass(cutoff_hz: float, fs: float, atten_db: float = 90.0,
                   transition_hz: float | None = None) -> np.ndarray:
    """Kaiser-window lowpass sized from the attenuation and transition."""
    if transition_hz is None:
        transition_hz = 0.2 * cutoff_hz
    ntaps, beta = _sig.kaiserord(atten_db, transition_hz / (0.5 * fs))
    ntaps |= 1  # force odd for a symmetric type-I filter
    return _sig.firwin(ntaps, cutoff_hz, fs=fs, window=("kaiser", beta))


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


def interpolator(interp: int, fs_out: float, atten_db: float = 90.0,
                 passband_frac: float = 0.4) -> np.ndarray:
    """Image-reject lowpass for an integer interpolator (gain = interp)."""
    fs_in = fs_out / interp
    cutoff = passband_frac * fs_in
    transition = (0.5 - passband_frac) * fs_in
    ntaps, beta = _sig.kaiserord(atten_db, transition / (0.5 * fs_out))
    ntaps |= 1
    h = _sig.firwin(ntaps, cutoff + transition / 2.0, fs=fs_out,
                    window=("kaiser", beta))
    return h * interp  # compensate zero-stuffing energy loss


def remez_bandpass(ntaps: int, f1: float, f2: float, fs: float,
                   transition_hz: float = 300.0) -> np.ndarray:
    """Equiripple real bandpass (the premade sets of filters.py)."""
    eps = transition_hz
    lo = max(f1 - eps, 1.0)
    hi = min(f2 + eps, fs / 2.0 - 1.0)
    if f1 <= eps:
        bands = [0.0, f2, hi, fs / 2.0]
        desired = [1.0, 0.0]
    else:
        bands = [0.0, lo, f1, f2, hi, fs / 2.0]
        desired = [0.0, 1.0, 0.0]
    return _sig.remez(ntaps, bands, desired, fs=fs)


def cic_compensator(ntaps: int, stages: int, decim: int, fs_out: float,
                    passband_frac: float = 0.4) -> np.ndarray:
    """FIR flattening the sinc^N droop of an N-stage CIC decimator
    (wdsp/icfir.c).  It runs at the CIC's output rate ``fs_out``: response
    1/|sinc|^N over the passband, a raised-cosine rolloff from
    ``passband_frac * fs_out`` to fs_out/2."""
    if ntaps % 2 == 0:
        ntaps += 1
    n = 4096
    f = np.fft.rfftfreq(n, d=1.0 / fs_out)
    fin = fs_out * decim
    num = np.sin(np.pi * f * decim / fin)
    den = decim * np.sin(np.pi * f / fin)
    mag = np.ones_like(f)
    nz = den != 0.0
    mag[nz] = np.abs(num[nz] / den[nz])
    comp = np.zeros_like(f)
    pb = f <= passband_frac * fs_out
    comp[pb] = 1.0 / np.maximum(mag[pb], 1e-6) ** stages
    trans = (f > passband_frac * fs_out) & (f < 0.5 * fs_out)
    if trans.any():
        tt = (f[trans] - passband_frac * fs_out) / (
            0.5 * fs_out - passband_frac * fs_out)
        comp[trans] = comp[pb][-1] * 0.5 * (1.0 + np.cos(np.pi * tt))
    h = np.fft.irfft(comp, n)
    return np.roll(h, ntaps // 2)[:ntaps] * np.blackman(ntaps)


def freq_response(taps: np.ndarray, fs: float, n: int = 4096):
    """(freqs_hz, complex response) over [-fs/2, fs/2) for design checks."""
    t = np.asarray(taps, dtype=np.complex128)
    H = np.fft.fftshift(np.fft.fft(t, n))
    f = np.fft.fftshift(np.fft.fftfreq(n, d=1.0 / fs))
    return f, H
