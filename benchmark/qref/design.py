"""Filter designs, worked out again for the reference from the
configuration alone (float64 NumPy / SciPy).

These follow the receiver's published plan (Quisk's decimation chain of
half-bands and Kaiser FIRs, quisk.c:1633-1843; its windowed-sinc channel
filters, quisk.py:5405 MakeFilterCoef; the standard DFT filterbank
prototype), so the reference holds the program to the same filters
without reading any table the program built.
"""

from __future__ import annotations

import math
from fractions import Fraction

import numpy as np
from scipy import signal as sig

# Mode ids and default bandwidths of the receiver's mode set (quisk.h:55-70,
# quisk_conf_defaults.py FilterBw*).
MODE_IDS = {"CWL": 0, "CWU": 1, "LSB": 2, "USB": 3, "AM": 4, "FM": 5}
BANDWIDTH = {"CWL": 500.0, "CWU": 500.0, "LSB": 2800.0, "USB": 2800.0,
             "AM": 6000.0, "FM": 12500.0}
CW_PITCH = 600.0


def halfband(ntaps: int = 45, atten_db: float = 120.0) -> np.ndarray:
    """Half-band lowpass for /2 (filter.c:379-385): even offsets but the
    centre zeroed, unity DC gain."""
    h = sig.firwin(ntaps, 0.5, window=("kaiser", sig.kaiser_beta(atten_db)))
    k = np.arange(ntaps) - (ntaps - 1) // 2
    h[(k % 2 == 0) & (k != 0)] = 0.0
    return h / h.sum()


def decimator(decim: int, fs_in: float, atten_db: float = 100.0,
              passband_frac: float = 0.4) -> np.ndarray:
    """Kaiser anti-alias lowpass of an integer stage: passband to
    0.4 fs_out, stopband from fs_out/2."""
    fs_out = fs_in / decim
    cutoff = passband_frac * fs_out
    transition = (0.5 - passband_frac) * fs_out
    ntaps, beta = sig.kaiserord(atten_db, transition / (0.5 * fs_in))
    ntaps |= 1
    return sig.firwin(ntaps, cutoff + transition / 2.0, fs=fs_in,
                      window=("kaiser", beta))


def decimation_stages(fs_in: float, fs_out: float) -> list[int]:
    """The integer stages: the largest 2^a 3^b 5^c divisor of the ratio,
    halves first, then fives, then threes."""
    ratio = fs_in / fs_out + 1e-9
    best = 1
    p2 = 1
    while p2 <= ratio:
        p23 = p2
        while p23 <= ratio:
            p235 = p23
            while p235 <= ratio:
                best = max(best, p235)
                p235 *= 5
            p23 *= 3
        p2 *= 2
    if abs(fs_in / best - fs_out) > 1e-6:
        frac = Fraction(fs_in / best / fs_out).limit_denominator(4096)
        raise ValueError(f"a fractional stage ({frac}) is not in the "
                         f"reference")
    stages = []
    for p in (2, 5, 3):
        while best % p == 0:
            stages.append(p)
            best //= p
    return stages


def front_taps(fs_in: float, fs_out: float, atten_db: float = 100.0
               ) -> tuple[np.ndarray, int]:
    """The whole decimation cascade folded into one filter by
    decim_d2(h2 * decim_d1(h1 * x)) = decim_d1d2((h1 * up_d1(h2)) * x).
    Returns (taps float64, total decimation)."""
    comb, d_tot, fs = None, 1, fs_in
    for d in decimation_stages(fs_in, fs_out):
        taps = halfband(45) if d == 2 else decimator(d, fs, atten_db)
        if comb is None:
            comb = taps
        else:
            up = np.zeros((len(taps) - 1) * d_tot + 1)
            up[::d_tot] = taps
            comb = np.convolve(comb, up)
        d_tot *= d
        fs /= d
    return comb, d_tot


def mode_band(mode: str, bandwidth: float | None = None) -> tuple[float, float]:
    """Audio passband edges (Hz) of a mode: SSB from 300 Hz off the
    carrier, CW about the pitch, AM / FM symmetric."""
    bw = BANDWIDTH[mode] if bandwidth is None else float(bandwidth)
    if mode in ("CWU", "CWL"):
        lo, hi = CW_PITCH - bw / 2.0, CW_PITCH + bw / 2.0
        return (-hi, -lo) if mode == "CWL" else (lo, hi)
    if mode in ("USB", "LSB"):
        lo, hi = 300.0, 300.0 + bw
        return (-hi, -lo) if mode == "LSB" else (lo, hi)
    return (-bw / 2.0, bw / 2.0)


def bandpass(ntaps: int, f1: float, f2: float, fs: float) -> np.ndarray:
    """Complex analytic bandpass over [f1, f2]: a Blackman windowed-sinc
    lowpass of half the width, shifted to the band's centre."""
    if ntaps % 2 == 0:
        ntaps += 1
    lp = sig.firwin(ntaps, (f2 - f1) / 2.0, fs=fs, window="blackman")
    k = np.arange(ntaps, dtype=np.float64) - (ntaps - 1) / 2.0
    return lp * np.exp(2j * np.pi * ((f1 + f2) / 2.0) * k / fs)


def freq_word(freq_hz, fs: float) -> np.ndarray:
    """uint32 phase increments (2^32 counts a turn) as int64."""
    f = np.atleast_1d(np.asarray(freq_hz, dtype=np.float64))
    return np.round(f / fs * 4294967296.0).astype(np.int64) % (1 << 32)


def pfb_prototype(n_chan: int, taps_per_branch: int, atten_db: float
                  ) -> np.ndarray:
    """Kaiser prototype lowpass of the DFT filterbank: P*K taps, cutoff at
    the channel half-width, unity DC gain."""
    n = n_chan * taps_per_branch
    h = sig.firwin(n, 1.0 / n_chan, window=("kaiser",
                                           sig.kaiser_beta(atten_db)))
    return h / h.sum()


def next_pow2(n: int) -> int:
    return 1 << max(0, math.ceil(math.log2(n)))
