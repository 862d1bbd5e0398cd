"""Adaptive predistortion (PureSignal) for the TX chain.

wdsp/calcc.c calibrates (correlate the TX signal with the PA feedback, fit
a complex gain against envelope, build the inverse) and iqc.c applies the
correction; the reference's own PreDistort (microphone.c:1581-1676) does
the same with splines.  Method:

1. align the feedback to the reference (integer lag by cross-correlation,
   complex gain by least squares);
2. bin the samples by reference envelope; per bin the PA's complex gain
   g(e) = <fb * conj(ref)> / <|ref|^2>;
3. fit the AM/AM and AM/PM curves to an even-order model and invert it
   on a dense drive grid;
4. apply the correction by an envelope-indexed table lookup with linear
   interpolation, batched over channels, on the device.

Calibration is host float64 NumPy at a slow cadence; the table is data.
:class:`SimulatedPA` and :func:`two_tone_imd_db` are the test bench.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from quisk_tpu_torch._device import resolve_device


def _align(ref: np.ndarray, fb: np.ndarray, max_lag: int = 256):
    """Align feedback to reference: integer lag + complex gain."""
    n = min(len(ref), len(fb))
    r, f = ref[:n], fb[:n]
    c = np.correlate(f, r, "full")
    lag = int(np.argmax(np.abs(c))) - (n - 1)
    if lag > 0:
        r2, f2 = r[: n - lag], f[lag:]
    else:
        r2, f2 = r[-lag:], f[: n + lag]
    g = np.vdot(r2, f2) / (np.vdot(r2, r2) + 1e-30)
    return r2, f2 / g, lag, g


def measure_pa_gain(ref: np.ndarray, feedback: np.ndarray, n_bins: int = 64,
                    smooth: int = 5):
    """(envelope grid [n_bins], complex gain [n_bins]) of the PA,
    normalised by the alignment's average gain; bins with too few samples
    take their nearest measured neighbour's value."""
    ref = np.asarray(ref, np.complex128)
    fb = np.asarray(feedback, np.complex128)
    r, f, _, _ = _align(ref, fb)
    env = np.abs(r)
    emax = float(np.max(env)) + 1e-12
    idx = np.minimum((env / emax * n_bins).astype(np.int64), n_bins - 1)
    num = np.zeros(n_bins, np.complex128)
    den = np.zeros(n_bins)
    cnt = np.zeros(n_bins)
    np.add.at(num, idx, f * np.conj(r))
    np.add.at(den, idx, env ** 2)
    np.add.at(cnt, idx, 1.0)
    good = (cnt > 8) & (den > 1e-20)
    g = np.ones(n_bins, np.complex128)
    g[good] = num[good] / den[good]
    if good.any():
        gi = np.where(good)[0]
        for k in np.where(~good)[0]:
            g[k] = g[gi[np.argmin(np.abs(gi - k))]]
    if smooth > 1:
        kern = np.ones(smooth) / smooth
        g = (np.convolve(g.real, kern, "same")
             + 1j * np.convolve(g.imag, kern, "same"))
    grid = (np.arange(n_bins) + 0.5) / n_bins * emax
    return grid, g


def _fit_and_invert(ref, feedback, n_bins: int, extend: float = 1.25):
    """Fit the PA to |g| = 1 + b2 e^2 + b4 e^4, arg g = p2 e^2 + p4 e^4 and
    build the inverse correction table (tab_env [n_bins], c [n_bins])."""
    grid, g = measure_pa_gain(ref, feedback, 64, smooth=1)
    g = g / g[4]                 # relative to the small-signal gain
    E = np.stack([grid ** 2, grid ** 4], axis=1)
    m = slice(4, len(grid))
    bm, *_ = np.linalg.lstsq(E[m], np.abs(g[m]) - 1.0, rcond=None)
    bp, *_ = np.linalg.lstsq(E[m], np.angle(g[m]), rcond=None)

    def gmag(a):
        return 1.0 + bm[0] * a ** 2 + bm[1] * a ** 4

    def gph(a):
        return bp[0] * a ** 2 + bp[1] * a ** 4
    # invert a*|g(a)| = e on a dense drive grid up to the model's peak,
    # reaching modestly past the measured envelope
    emax = grid[-1] * extend
    tab_e = np.arange(n_bins) / (n_bins - 1) * emax
    a_grid = np.linspace(0.0, grid[-1] * 1.6, 2048)
    out = a_grid * np.clip(gmag(a_grid), 0.05, None)
    peak = int(np.argmax(out))
    a_req = np.interp(tab_e, out[: peak + 1], a_grid[: peak + 1],
                      right=a_grid[peak])
    c = np.where(tab_e > 0, a_req / np.maximum(tab_e, 1e-9), 1.0) \
        * np.exp(-1j * gph(a_req))
    return tab_e, c


@dataclasses.dataclass(frozen=True)
class Predistorter:
    """Envelope-indexed complex-gain correction ``y = x * c(|x|)`` with
    linear interpolation between table entries; the table (c_re, c_im
    float32 [n_bins], env_max 0-dim) is data, so recalibration swaps it."""

    c_re: torch.Tensor
    c_im: torch.Tensor
    env_max: torch.Tensor          # top of the table's envelope range

    @classmethod
    def _of(cls, c: np.ndarray, env_max: float, device) -> "Predistorter":
        return cls(c_re=torch.as_tensor(np.asarray(c.real, np.float32),
                                        device=device),
                   c_im=torch.as_tensor(np.asarray(c.imag, np.float32),
                                        device=device),
                   env_max=torch.tensor(np.float32(env_max), device=device))

    @classmethod
    def identity(cls, n_bins: int = 256, device=None) -> "Predistorter":
        return cls._of(np.ones(n_bins, np.complex128), 1.0,
                       resolve_device(device))

    @classmethod
    def from_measurement(cls, ref, feedback, n_bins: int = 256,
                         device=None) -> "Predistorter":
        """Calibrate from a (reference, PA feedback) capture."""
        tab_e, c = _fit_and_invert(ref, feedback, n_bins)
        return cls._of(c, tab_e[-1], resolve_device(device))

    def refine(self, ref, feedback, n_bins: int = 256) -> "Predistorter":
        """One PureSignal iteration: ``feedback`` was captured with this
        predistorter applied; fold in the correction of the residual
        nonlinearity, c_total(e) = c_resid(e) * c_old(e * |c_resid(e)|)
        (calcc.c recalibrates continuously during TX)."""
        tab_e, c2 = _fit_and_invert(ref, feedback, n_bins)
        c_re = self.c_re.cpu().numpy()
        e_old = float(self.env_max) * np.arange(len(c_re)) / (len(c_re) - 1)
        c_old = c_re + 1j * self.c_im.cpu().numpy()
        e_mod = tab_e * np.abs(c2)
        c1i = (np.interp(e_mod, e_old, c_old.real)
               + 1j * np.interp(e_mod, e_old, c_old.imag))
        return self._of(c2 * c1i, tab_e[-1], self.c_re.device)

    def init_state(self, channels: int):
        return ()

    def __call__(self, state, x: torch.Tensor):
        """x [C, B] complex TX signal -> the predistorted signal."""
        n = self.c_re.shape[0]
        pos = torch.clamp(torch.abs(x) / self.env_max * (n - 1), 0.0, n - 1.0)
        k = torch.clamp(pos.to(torch.int64), max=n - 2)
        fr = pos - k.to(pos.dtype)
        c_re = self.c_re[k] * (1.0 - fr) + self.c_re[k + 1] * fr
        c_im = self.c_im[k] * (1.0 - fr) + self.c_im[k + 1] * fr
        return state, x * torch.complex(c_re, c_im)


class SimulatedPA:
    """Memoryless nonlinear PA model for closed-loop calibration: odd-order
    AM/AM compression plus envelope-dependent AM/PM rotation and a hard
    limit (the distortion family calcc.c measures and inverts)."""

    def __init__(self, g3: complex = -0.22 + 0.06j, g5: complex = 0.05,
                 ampm_rad: float = 0.12, sat: float = 1.5):
        self.g3, self.g5, self.ampm, self.sat = g3, g5, ampm_rad, sat

    def __call__(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x)
        e2 = np.abs(x) ** 2
        y = x * (1.0 + self.g3 * e2 + self.g5 * e2 ** 2)
        y = y * np.exp(1j * self.ampm * e2)
        mag = np.abs(y)
        y = np.where(mag > self.sat,
                     y * self.sat / np.maximum(mag, 1e-30), y)
        return y.astype(np.complex64)


def two_tone_imd_db(iq: np.ndarray, fs: float, f1: float, f2: float) -> float:
    """Third-order IMD level (dBc) of a two-tone signal (the reference's
    IMD test mode, microphone.c:140-159)."""
    n = len(iq)
    w = np.hanning(n)
    S = np.abs(np.fft.fft(iq * w))
    f = np.fft.fftfreq(n, 1.0 / fs)

    def peak(freq):
        k = np.argmin(np.abs(f - freq))
        return np.max(S[max(k - 3, 0):k + 4])

    carrier = max(peak(f1), peak(f2))
    imd = max(peak(2 * f1 - f2), peak(2 * f2 - f1))
    return 20.0 * np.log10(imd / (carrier + 1e-30))
