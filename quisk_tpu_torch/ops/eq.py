"""Audio shaping in the frequency domain: graphic EQ and the continuous
frequency compressor.

- wdsp/eq.c: a graphic equalizer whose impulse response is designed by
  frequency sampling from per-band dB gains (host float64, :func:`eq_taps`)
  and run as a streaming FIR (:class:`GraphicEQ`).
- wdsp/cfcomp.c: the continuous frequency compressor, an STFT processor
  that tracks each bin's level with attack / release smoothing and pulls
  it toward a target profile (:class:`CFCompressor`): sqrt-Hann frames at
  50% overlap, the per-frame level recurrence a Python loop over the
  block's frames.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from quisk_tpu_torch._device import resolve_device
from quisk_tpu_torch.ops.fir import ConvFIR
from quisk_tpu_torch.ops.scanutil import time_scan


def eq_taps(ntaps: int, freqs_hz, gains_db, fs: float) -> np.ndarray:
    """Linear-phase FIR whose magnitude follows the (freq, dB) control
    points (wdsp/eq.c eq_mults): gains interpolated linearly in dB over
    log-frequency, held below the first and above the last point."""
    if ntaps % 2 == 0:
        ntaps += 1
    freqs = np.asarray(freqs_hz, np.float64)
    gains = np.asarray(gains_db, np.float64)
    if freqs.shape != gains.shape or freqs.ndim != 1 or len(freqs) < 2:
        raise ValueError("need matching 1-D freq/gain control points (>=2)")
    n = 8 * 1 << (ntaps - 1).bit_length()          # dense design grid
    f = np.fft.rfftfreq(n, d=1.0 / fs)
    lf = np.log10(np.maximum(f, freqs[0] / 4 + 1e-6))
    mag_db = np.interp(lf, np.log10(freqs), gains,
                       left=gains[0], right=gains[-1])
    mag = 10.0 ** (mag_db / 20.0)
    h = np.fft.irfft(mag, n)
    h = np.roll(h, ntaps // 2)[:ntaps]
    h *= np.blackman(ntaps)
    return h


@dataclasses.dataclass(frozen=True)
class GraphicEQ:
    """Per-channel graphic equalizer on real audio ``[C, block]``: a real
    streaming FIR with frequency-sampled taps; :meth:`retune` swaps the
    taps (wdsp/firmin.c:322-346 double-buffers them for the same reason).
    State: float32 [C, ntaps-1]."""

    fir: ConvFIR
    fs: float
    ntaps: int

    @classmethod
    def create(cls, block: int, fs: float, freqs_hz=None, gains_db=None,
               ntaps: int = 257, device=None):
        if freqs_hz is None:
            freqs_hz = [30.0, 125.0, 500.0, 2000.0, 8000.0]
        if gains_db is None:
            gains_db = [0.0] * len(freqs_hz)
        taps = eq_taps(ntaps, freqs_hz, gains_db, fs)
        fir = ConvFIR.create(taps, block, complex_state=False, device=device)
        return cls(fir=fir, fs=fs, ntaps=fir.ntaps)

    def retune(self, freqs_hz, gains_db) -> "GraphicEQ":
        taps = eq_taps(self.ntaps, freqs_hz, gains_db, self.fs)
        h_rev = np.ascontiguousarray(taps[::-1]).astype(np.float32)
        return dataclasses.replace(self, fir=dataclasses.replace(
            self.fir, h_rev=torch.as_tensor(h_rev,
                                            device=self.fir.h_rev.device)))

    def init_state(self, channels: int):
        return self.fir.init_state(channels)

    def __call__(self, state, a: torch.Tensor):
        return self.fir(state, a)


@dataclasses.dataclass(frozen=True)
class CFCompressor:
    """Continuous frequency compressor on real audio ``[C, block]``
    (wdsp/cfcomp.c).

    Per STFT frame each bin's level (dB) follows attack / release
    smoothing; the gain pulls it toward ``target_db`` with slope
    ``1 - 1/ratio``, bounded by ``max_gain_db`` / ``max_cut_db``, and bins
    40 dB under the target get none.  sqrt-Hann analysis and synthesis at
    50% overlap reconstruct exactly at 0 dB.

    State: (in_tail [C, H], out_tail [C, H], level_db [C, F]), H = fft/2,
    F = fft/2 + 1."""

    window: torch.Tensor
    norm_db: float                  # full-scale-sine offset
    fft: int
    block: int
    target_db: float
    inv_ratio: float
    attack: float                   # per-frame coefficients
    release: float
    max_gain_db: float
    max_cut_db: float

    @classmethod
    def create(cls, block: int, fs: float, fft: int = 512,
               target_db: float = -12.0, ratio: float = 3.0,
               attack_ms: float = 5.0, release_ms: float = 80.0,
               max_gain_db: float = 18.0, max_cut_db: float = 18.0,
               device=None):
        device = resolve_device(device)
        if block % (fft // 2):
            raise ValueError("block must be a multiple of fft/2")
        w = np.sqrt(np.hanning(fft + 1)[:fft])
        frame_rate = fs / (fft // 2)
        atk = float(1.0 - np.exp(-1.0 / (attack_ms * 1e-3 * frame_rate)))
        rel = float(1.0 - np.exp(-1.0 / (release_ms * 1e-3 * frame_rate)))
        # a full-scale sine at a bin center measures |X| = sum(w)/2: 0 dBFS
        norm = float(20.0 * np.log10(np.sum(w) / 2.0))
        return cls(window=torch.as_tensor(w.astype(np.float32),
                                          device=device),
                   norm_db=norm, fft=fft, block=block,
                   target_db=float(target_db), inv_ratio=float(1.0 / ratio),
                   attack=atk, release=rel, max_gain_db=float(max_gain_db),
                   max_cut_db=float(max_cut_db))

    def init_state(self, channels: int):
        H = self.fft // 2
        dev = self.window.device
        return (torch.zeros((channels, H), dtype=torch.float32, device=dev),
                torch.zeros((channels, H), dtype=torch.float32, device=dev),
                torch.full((channels, H + 1), -120.0, dtype=torch.float32,
                           device=dev))

    def __call__(self, state, a: torch.Tensor):
        in_tail, out_tail, level_db = state
        C = a.shape[0]
        H = self.fft // 2
        nfrm = a.shape[-1] // H
        ext = torch.cat([in_tail, a], dim=-1)
        tiles = ext.reshape(C, nfrm + 1, H)
        frames = torch.cat([tiles[:, :-1], tiles[:, 1:]], dim=-1) * self.window
        X = torch.fft.rfft(frames, dim=-1)
        S2 = torch.abs(X) ** 2
        # moving max over +-2 bins, so a tone's whole footprint sees one
        # level and one gain
        F = S2.shape[-1]
        pad = torch.cat([S2[..., :1], S2[..., :1], S2,
                         S2[..., -1:], S2[..., -1:]], dim=-1)
        S2m = torch.stack([pad[..., k:k + F] for k in range(5)]).amax(dim=0)
        inst_db = 10.0 * torch.log10(S2m + 1e-12) - self.norm_db
        f32 = np.float32

        def frame_step(lev, xs):
            coef = torch.where(xs > lev, f32(self.attack), f32(self.release))
            lev = lev + coef * (xs - lev)
            gain_db = torch.clamp((self.target_db - lev)
                                  * f32(1.0 - self.inv_ratio),
                                  -self.max_cut_db, self.max_gain_db)
            gain_db = torch.where(lev < f32(self.target_db - 40.0), 0.0,
                                  gain_db)
            return lev, gain_db

        level_db, gains_db = time_scan(frame_step, level_db, inst_db, dim=1)
        g = 10.0 ** (gains_db / 20.0)
        y = torch.fft.irfft(X * g.to(X.dtype), n=self.fft,
                            dim=-1) * self.window
        # overlap-add of shifted half-frame views
        zero = torch.zeros_like(y[:, :1, :H])
        out_tiles = (torch.cat([y[:, :, :H], zero], dim=1)
                     + torch.cat([zero, y[:, :, H:]], dim=1))
        out_tiles = torch.cat([out_tiles[:, :1] + out_tail[:, None],
                               out_tiles[:, 1:]], dim=1)
        out = out_tiles.reshape(C, (nfrm + 1) * H)
        return ((ext[:, ext.shape[-1] - H:], out[:, nfrm * H:],
                 level_db), out[:, :nfrm * H])
