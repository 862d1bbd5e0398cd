"""Spectrum analysis: batched windowed FFT averaging, dB graphs, S-meter,
frequency measurement and the zoom re-capture.

The reference's graph engine (quisk.c:5142 ``get_graph``): windowed FFTs
accumulated (quisk.c:2454-2475) and averaged, converted to dB re full
scale, re-binned to screen pixels with zoom and pan (5289-5301); the
S-meter sums the power bins inside the passband with the window's
leakage correction (5218-5244, 5311); ``measure_frequency``
(quisk.c:5579-5650) is the parabolic-interpolated FFT peak.  The
accumulation is carried state, so any consumer reads the running
average.  ``torch.fft`` throughout.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from quisk_tpu_torch._device import resolve_device
from quisk_tpu_torch.ops.design import kaiser_lowpass
from quisk_tpu_torch.ops.fir import MatmulFIR
from quisk_tpu_torch.ops.nco import NCO


def hann(n: int) -> np.ndarray:
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)


_WINDOWS = {
    "rect": (1.0,),
    "hann": (0.5, -0.5),
    "hamming": (0.54, -0.46),
    "blackman": (0.42, -0.5, 0.08),
    # 4-term -92 dB Blackman-Harris (the wdsp analyzer default family)
    "blackman-harris": (0.35875, -0.48829, 0.14128, -0.01168),
    # SRS flat-top: near-zero scalloping loss, for amplitude accuracy
    "flat-top": (0.21557895, -0.41663158, 0.277263158,
                 -0.083578947, 0.006947368),
}


def make_window(name: str, n: int) -> np.ndarray:
    """Cosine-sum analysis window by name (the reference's Hann graph
    window, quisk.c:5212, and wdsp/analyzer.c's window table)."""
    if name not in _WINDOWS:
        raise ValueError(f"unknown window {name!r}; "
                         f"choices: {sorted(_WINDOWS)}")
    t = 2.0 * np.pi * np.arange(n) / n
    return sum(a * np.cos(k * t) for k, a in enumerate(_WINDOWS[name]))


def _enbw_bins(w: np.ndarray) -> float:
    """Equivalent noise bandwidth of a window in FFT bins (1.0 rect, 1.5
    Hann, ~2.0 Blackman-Harris, ~3.77 flat-top)."""
    w = np.asarray(w, np.float64)
    return float(len(w) * np.sum(w ** 2) / np.sum(w) ** 2)


def _window_tensors(name: str, n: int, device):
    w = make_window(name, n)
    enbw = _enbw_bins(w)
    w = w / w.sum()                  # a full-scale complex tone reads 0 dBFS
    return (torch.as_tensor(w.astype(np.float32), device=device),
            torch.tensor(np.float32(enbw), device=device))


@dataclasses.dataclass(frozen=True)
class SpectrumAnalyzer:
    """Accumulating power spectrum over ``[C, block]`` IQ blocks.

    ``hop == fft_size`` takes disjoint frames; a smaller hop overlapped
    frames (wdsp/analyzer.c's overlap), the trailing fft_size - hop input
    samples carried.  The window and its ENBW are data
    (:meth:`with_window`), so the S-meter stays exact for every window.

    State: (psum [C, fft_size] float32, count 0-dim float32) and, when
    overlapped, the carried samples complex64 [C, fft_size - hop]."""

    window: torch.Tensor            # [fft_size] float32
    enbw_bins: torch.Tensor         # 0-dim: window ENBW in bins
    fft_size: int
    block: int
    hop: int = 0

    @classmethod
    def create(cls, fft_size: int, block: int, window: str = "hann",
               overlap: float = 0.0, device=None) -> "SpectrumAnalyzer":
        """``overlap`` is the frame-overlap fraction (0, 0.5, 0.75, ...);
        hop = fft_size*(1-overlap) must divide fft_size and block."""
        device = resolve_device(device)
        if block % fft_size:
            raise ValueError(f"block {block} not a multiple of fft {fft_size}")
        hop = int(round(fft_size * (1.0 - overlap)))
        if not 0 < hop <= fft_size or fft_size % hop or block % hop:
            raise ValueError(
                f"overlap {overlap} needs hop = fft*(1-overlap) to divide "
                f"fft_size {fft_size} and block {block} (got hop {hop})")
        w, enbw = _window_tensors(window, fft_size, device)
        return cls(window=w, enbw_bins=enbw, fft_size=fft_size, block=block,
                   hop=hop)

    def with_window(self, window: str) -> "SpectrumAnalyzer":
        """Same analyzer and state shapes, another window."""
        w, enbw = _window_tensors(window, self.fft_size, self.window.device)
        return dataclasses.replace(self, window=w, enbw_bins=enbw)

    def init_state(self, channels: int):
        dev = self.window.device
        base = (torch.zeros((channels, self.fft_size), dtype=torch.float32,
                            device=dev),
                torch.zeros((), dtype=torch.float32, device=dev))
        if self.hop == self.fft_size:
            return base
        return base + (torch.zeros((channels, self.fft_size - self.hop),
                                   dtype=torch.complex64, device=dev),)

    def accumulate(self, state, x: torch.Tensor):
        L = self.fft_size
        C = x.shape[0]
        if self.hop == L:                         # disjoint frames
            psum, count = state
            X = torch.fft.fft(x.reshape(C, -1, L) * self.window, dim=-1)
            p = torch.mean(torch.abs(X) ** 2, dim=1)
            return (psum + p, count + 1.0), None
        # overlapped: frame i*hop falls in group i mod q of q = L/hop
        # strided views of the history-extended block
        psum, count, hist = state
        hop = self.hop
        xe = torch.cat([hist, x.to(torch.complex64)], dim=-1)
        n = xe.shape[-1]                          # block + L - hop
        p = torch.zeros((C, L), dtype=torch.float32, device=x.device)
        for i in range(L // hop):
            nj = (n - i * hop - L) // L + 1
            seg = xe[:, i * hop: i * hop + nj * L].reshape(C, nj, L)
            p = p + torch.sum(torch.abs(torch.fft.fft(seg * self.window,
                                                      dim=-1)) ** 2, dim=1)
        total = x.shape[-1] // hop                # frames this block
        return (psum + p / total, count + 1.0, xe[:, n - (L - hop):]), None

    def power(self, state) -> torch.Tensor:
        """Averaged linear power, fftshifted so index 0 = -fs/2. [C, F]."""
        psum, count = state[0], state[1]
        return torch.fft.fftshift(psum / torch.clamp(count, min=1.0),
                                  dim=-1)

    def graph_db(self, state, floor_db: float = -180.0) -> torch.Tensor:
        """Averaged spectrum in dB re full-scale tone. [C, F]."""
        p = self.power(state)
        return 10.0 * torch.log10(torch.clamp(p, min=10.0 ** (floor_db
                                                               / 10.0)))

    def freqs(self, sample_rate: float) -> np.ndarray:
        return np.fft.fftshift(np.fft.fftfreq(self.fft_size,
                                              1.0 / sample_rate))

    def smeter_power(self, state, sample_rate: float, f_lo,
                     f_hi) -> torch.Tensor:
        """Total power in [f_lo, f_hi] per channel (f_lo / f_hi scalars or
        [C]), divided by the window's ENBW so a tone's bin-summed power is
        exact for every window (quisk.c:5311's fixed Hann correction,
        generalised)."""
        p = self.power(state)
        C, dev = p.shape[0], p.device
        f = torch.as_tensor(self.freqs(sample_rate).astype(np.float32),
                            device=dev)
        lo = torch.as_tensor(np.broadcast_to(
            np.asarray(f_lo, np.float32), (C,)).copy(), device=dev)
        hi = torch.as_tensor(np.broadcast_to(
            np.asarray(f_hi, np.float32), (C,)).copy(), device=dev)
        mask = (f[None, :] >= lo[:, None]) & (f[None, :] <= hi[:, None])
        return (torch.sum(torch.where(mask, p, 0.0), dim=-1)
                / self.enbw_bins)

    def reset(self, state):
        """Zero the running average; the overlapped mode keeps its
        samples."""
        return (torch.zeros_like(state[0]),
                torch.zeros_like(state[1])) + tuple(state[2:])


def measure_frequency(x: torch.Tensor, sample_rate: float) -> torch.Tensor:
    """The dominant tone's frequency per channel ``[C]`` from one block:
    Hann-windowed FFT peak plus parabolic interpolation."""
    C, B = x.shape
    w = torch.as_tensor(hann(B).astype(np.float32), device=x.device)
    mag = torch.abs(torch.fft.fft(x * w, dim=-1))
    k = torch.argmax(mag, dim=-1)
    c = mag.gather(1, k[:, None])[:, 0]
    a = mag.gather(1, ((k - 1) % B)[:, None])[:, 0]
    b = mag.gather(1, ((k + 1) % B)[:, None])[:, 0]
    denom = a - 2 * c + b
    mu = torch.where(torch.abs(denom) > 1e-20, 0.5 * (a - b) / denom, 0.0)
    kf = k.to(torch.float32) + mu
    kf = torch.where(kf > B / 2, kf - B, kf)
    return kf * (sample_rate / B)


def _rebin_geometry(F: int, pixels: int, zoom: float, center_frac: float):
    span = int(F / zoom)
    start = int(F / 2 + center_frac * F - span / 2)
    start = max(0, min(F - span, start))
    per = max(1, span // pixels)
    return start, per


def rebin_pixels(db: torch.Tensor, pixels: int, zoom: float = 1.0,
                 center_frac: float = 0.0) -> torch.Tensor:
    """Re-bin a [C, F] dB spectrum to [C, pixels], max-holding within each
    pixel (zoom >= 1 narrows the view about center_frac of fs)."""
    C, F = db.shape
    start, per = _rebin_geometry(F, pixels, zoom, center_frac)
    v = db[:, start:start + per * pixels].reshape(C, pixels, per)
    return torch.amax(v, dim=-1)


def rebin_freqs(freqs: np.ndarray, pixels: int, zoom: float = 1.0,
                center_frac: float = 0.0) -> np.ndarray:
    """Center frequency of each display pixel of :func:`rebin_pixels`."""
    F = len(freqs)
    start, per = _rebin_geometry(F, pixels, zoom, center_frac)
    idx = start + np.arange(pixels) * per + per // 2
    return np.asarray(freqs)[np.minimum(idx, F - 1)]


@dataclasses.dataclass(frozen=True)
class ZoomSpectrum:
    """Zoom-FFT: re-capture a narrow passband at ``decim`` times finer
    resolution (wdsp/analyzer.c re-captures at the span it shows): mix the
    view center to baseband (NCO), lowpass and decimate by D
    (:class:`MatmulFIR`, Kaiser taps), and run a :class:`SpectrumAnalyzer`
    at fs/D.  NCO phase, FIR history and the average are carried state;
    :meth:`retuned` moves the center with a new NCO word."""

    nco: NCO
    fir: MatmulFIR
    an: SpectrumAnalyzer
    decim: int

    @classmethod
    def create(cls, fft_size: int, block: int, center_hz: float,
               sample_rate: float, decim: int, window: str = "hann",
               overlap: float = 0.5, atten_db: float = 80.0,
               device=None) -> "ZoomSpectrum":
        device = resolve_device(device)
        if block % decim or (block // decim) % fft_size:
            raise ValueError("need decim | block and fft_size | block/decim")
        # anti-alias lowpass at 90% of the zoomed Nyquist
        taps = kaiser_lowpass(0.45 * sample_rate / decim, sample_rate,
                              atten_db=atten_db)
        return cls(nco=NCO.create(center_hz, sample_rate, block, 1,
                                  device=device),
                   fir=MatmulFIR.create(taps, block, decim=decim,
                                        device=device),
                   an=SpectrumAnalyzer.create(fft_size, block // decim,
                                              window=window, overlap=overlap,
                                              device=device),
                   decim=decim)

    def retuned(self, center_hz: float, sample_rate: float) -> "ZoomSpectrum":
        return dataclasses.replace(self, nco=NCO.create(
            center_hz, sample_rate, self.nco.block, 1,
            device=self.nco.word.device))

    def init_state(self, channels: int):
        return (self.nco.init_state(channels),
                self.fir.init_state(channels),
                self.an.init_state(channels))

    def accumulate(self, state, x: torch.Tensor):
        ph, fh, an_st = state
        ph, bb = self.nco(ph, x)
        fh, y = self.fir(fh, bb)
        an_st, _ = self.an.accumulate(an_st, y)
        return (ph, fh, an_st), None

    def graph_db(self, state, floor_db: float = -180.0) -> torch.Tensor:
        return self.an.graph_db(state[2], floor_db)

    def power(self, state) -> torch.Tensor:
        return self.an.power(state[2])

    def freqs(self, sample_rate: float, center_hz: float = 0.0) -> np.ndarray:
        """Absolute frequencies of the zoomed view's bins."""
        return center_hz + self.an.freqs(sample_rate / self.decim)
