"""Reference DSP in float64 NumPy, one function per kernel under test.

These are *independent* implementations of the documented algorithms (see
SURVEY.md §2 for the reference file:line of each), used only by tests and
``chip_smoke.py`` — no torch, no float32, sequential semantics where the
real thing is sequential.  The port's copy of ``quisk_tpu.oracle.dsp``: it
imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np

TWO_PI = 2.0 * np.pi


def fir_stream(x: np.ndarray, taps: np.ndarray, hist: np.ndarray | None = None,
               decim: int = 1):
    """Streaming FIR: y[n] = sum_k h[k] x[n*decim - k], with carried history.

    Returns (new_hist, y).  x: [N] (1-D, single channel).
    """
    taps = np.asarray(taps)
    T = len(taps)
    if hist is None:
        hist = np.zeros(T - 1, dtype=np.result_type(x.dtype, taps.dtype))
    xe = np.concatenate([hist, x])
    full = np.convolve(xe, taps, mode="full")
    # valid, fully-overlapped outputs start at index T-1 of `full` relative
    # to xe; stream position 0 of this block is xe index T-1.
    y = full[T - 1: T - 1 + len(x): decim]
    return xe[len(xe) - (T - 1):], y


def nco_phase(n0: int, count: int, freq_hz: float, fs: float) -> np.ndarray:
    """Exact integer-accumulator NCO phase angles (matches ops/nco.py)."""
    word = int(round(freq_hz / fs * 2**32)) % 2**32
    idx = (n0 + np.arange(count, dtype=np.int64)) * word % 2**32
    return idx.astype(np.float64) * (TWO_PI / 2**32)


def mix_down(x: np.ndarray, freq_hz: float, fs: float, n0: int = 0) -> np.ndarray:
    return x * np.exp(-1j * nco_phase(n0, len(x), freq_hz, fs))


def ssb_demod(x: np.ndarray, gain: float = 2.0) -> np.ndarray:
    return gain * np.real(x)


def am_demod(x: np.ndarray, pole: float = 0.995, gain: float = 2.0,
             x_prev: float = 0.0, y_prev: float = 0.0) -> np.ndarray:
    env = np.abs(x)
    y = np.empty_like(env)
    for n in range(len(env)):
        yn = env[n] - x_prev + pole * y_prev
        x_prev, y_prev = env[n], yn
        y[n] = yn
    return gain * y


def fm_demod(x: np.ndarray, fs: float, deviation_hz: float = 5000.0,
             deemph_hz: float = 300.0, prev: complex = 0.0,
             y_prev: float = 0.0) -> np.ndarray:
    d = x * np.conj(np.concatenate([[prev], x[:-1]]))
    disc = np.arctan2(d.imag, d.real) * (fs / (TWO_PI * deviation_hz))
    a = np.exp(-TWO_PI * deemph_hz / fs)
    b = 1.0 - a
    y = np.empty_like(disc)
    for n in range(len(disc)):
        y_prev = a * y_prev + b * disc[n]
        y[n] = y_prev
    return y


def one_pole(x: np.ndarray, a: float, b: float, y_prev: float = 0.0) -> np.ndarray:
    y = np.empty_like(x)
    for n in range(len(x)):
        y_prev = a * y_prev + b * x[n]
        y[n] = y_prev
    return y


def agc(a: np.ndarray, fs: float, target: float = 0.9, max_gain_db: float = 80.0,
        release_db_per_s: float = 60.0, lookahead_ms: float = 15.0,
        delay: np.ndarray | None = None, lg0: float = 0.0):
    """Sequential reference of ops/agc.py (same lookahead/min-release law)."""
    W = max(1, int(round(lookahead_ms * 1e-3 * fs)))
    inc = np.log(10.0) * release_db_per_s / 20.0 / fs
    max_lg = np.log(10.0) * max_gain_db / 20.0
    if delay is None:
        delay = np.zeros(W)
    ext = np.concatenate([delay, a])
    out = np.empty(len(a))
    lg = lg0
    for n in range(len(a)):
        env = np.max(np.abs(ext[n: n + W]))
        limit = min(np.log(target / max(env, 1e-9)), max_lg)
        lg = min(lg + inc, limit)
        out[n] = ext[n] * np.exp(lg)
    return out


def snr_db(ref: np.ndarray, test: np.ndarray, skip: int = 0) -> float:
    """SNR of `test` against `ref` in dB, optionally skipping a transient."""
    r = np.asarray(ref)[skip:]
    t = np.asarray(test)[skip:]
    err = r - t
    p_sig = np.mean(np.abs(r) ** 2)
    p_err = np.mean(np.abs(err) ** 2)
    if p_err == 0:
        return np.inf
    return 10.0 * np.log10(p_sig / p_err)


def frac_align_snr(ref: np.ndarray, test: np.ndarray, max_lag: int = 2048,
                   skip: int = 0) -> float:
    """SNR after *fractional* delay + gain alignment of `test` to `ref`.

    Multirate chains have non-integer net group delay (e.g. a 45-tap
    half-band's 22-sample delay is 1.1 output samples after /20), which caps
    integer-lag SNR; this aligns with an FFT phase ramp at the correlation
    peak (parabolic-interpolated) before comparing.
    """
    r = np.asarray(ref, dtype=np.float64)[skip:]
    t = np.asarray(test, dtype=np.float64)[skip:]
    n = min(len(r), len(t))
    r, t = r[:n] - r[:n].mean(), t[:n] - t[:n].mean()
    # integer lag via cross-correlation (FFT)
    N = 1 << int(np.ceil(np.log2(2 * n)))
    X = np.fft.rfft(r, N) * np.conj(np.fft.rfft(t, N))
    xc = np.fft.irfft(X, N)
    lags = np.concatenate([np.arange(0, max_lag + 1), np.arange(-max_lag, 0)])
    seg = np.concatenate([xc[: max_lag + 1], xc[-max_lag:]])
    k = int(np.argmax(np.abs(seg)))
    lag = lags[k]
    # parabolic interpolation around the peak for the fractional part
    ym1, y0, yp1 = (xc[(lag - 1) % N], xc[lag % N], xc[(lag + 1) % N])
    denom = ym1 - 2 * y0 + yp1
    mu = 0.5 * (ym1 - yp1) / denom if abs(denom) > 1e-30 else 0.0
    mu = float(np.clip(mu, -1, 1))
    d = lag + mu          # test must be advanced by d to match ref
    # apply fractional delay to t via frequency-domain phase ramp
    f = np.fft.rfftfreq(N)
    T = np.fft.rfft(t, N) * np.exp(-2j * np.pi * f * d)
    t_al = np.fft.irfft(T, N)[:n]
    guard = int(np.ceil(abs(d))) + 8
    a, b = r[guard: n - guard], t_al[guard: n - guard]
    g = np.dot(a, b) / np.dot(b, b)
    return snr_db(a, g * b)


def align_and_snr(ref: np.ndarray, test: np.ndarray, max_lag: int = 0,
                  skip: int = 0, scale: bool = True) -> float:
    """SNR after optimally scaling (and optionally lag-aligning) `test`.

    Used for end-to-end chain checks where a pure delay / gain difference is
    expected (different but equivalent filter implementations).
    """
    r = np.asarray(ref, dtype=np.float64)[skip:]
    t = np.asarray(test, dtype=np.float64)[skip:]
    best = -np.inf
    for lag in range(-max_lag, max_lag + 1):
        if lag >= 0:
            a, b = r[lag:], t[: len(t) - lag]
        else:
            a, b = r[: len(r) + lag], t[-lag:]
        n = min(len(a), len(b))
        a, b = a[:n], b[:n]
        g = (np.dot(a, b) / np.dot(b, b)) if scale and np.dot(b, b) > 0 else 1.0
        best = max(best, snr_db(a, g * b))
    return best
