"""Noise mitigation: impulse noise blanker, FFT-domain auto-notch and the
spectral noise blanker.

Counterparts of ``quisk_tpu.ops.noise`` ``NoiseBlanker``, ``AutoNotch`` and
``SpectralNoiseBlanker``.

- Noise blanker (quisk.c:680 ``NoiseBlanker``): sliding magnitude average,
  pulse = sample > avg * limit (limits 6.0/4.0/2.5 by level), samples
  zeroed during the pulse with raised-cosine windows (~500 us half-window)
  before and after so the blanking itself does not click.
- Auto-notch (quisk.c:794 ``dAutoNotch``): block FFT of the audio, find up
  to two persistent spectral peaks, design an FFT-domain notch FIR (zero
  the bins, IFFT, window, re-FFT) and apply it overlap-save style.
- Spectral blanker (wdsp/snb.c): flag STFT frames whose broadband power
  jumps over the tracked background and replace their spectra with the
  last clean frame's.

Both are vectorised over ``[C, B]``.  The blanker's two sliding windows
(magnitude average, pulse widening) are sliding dot products, run as
banded-Toeplitz fp32 matmuls.  At wideband rates ``pool`` > 1 moves the
average and the ~1000-tap widening onto a P:1 coarse grid of group sums
and maxes (the detection set is the same: a group's max crosses iff one of
its samples does) and the gain is linearly upsampled; at pool 16 the chain
runs this detection inside the front kernel instead (ops/fused_front.py).
All dots are float32: the reference's one-pass bf16 product is a TPU
choice and is not carried over.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from quisk_tpu_torch._device import resolve_device
from quisk_tpu_torch.ops.fir import banded_taps
from quisk_tpu_torch.ops.nr import _frames, _overlap_add
from quisk_tpu_torch.ops.scanutil import time_scan


def sliding_dot(sig: torch.Tensor, kernel: torch.Tensor, n_out: int
                ) -> torch.Tensor:
    """out[c, n] = sum_k sig[c, n + k] * kernel[K-1-k] for n < n_out, with
    sig [C, n_out + K - 1]: patches of R + K - 1 samples times the banded
    [R + K - 1, R] matrix (R up to 1024 keeps the patch copy under 2x)."""
    C = sig.shape[0]
    R = 1024
    while n_out % R:
        R //= 2
    M = banded_taps(kernel.flip(0), R, 1)
    patches = sig.unfold(-1, M.shape[0], R)             # [C, n_out/R, R+K-1]
    return torch.matmul(patches, M).reshape(C, n_out)


def raised_cosine(k: int) -> np.ndarray:
    """The blanking window's k taps, float32: 0 at both ends, 1 at the
    centre."""
    return (0.5 + 0.5 * np.cos(np.linspace(-np.pi, np.pi, k))
            ).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class NoiseBlanker:
    """Impulse blanker on raw IQ blocks.

    ``limit`` is a 0-dim float32 tensor (data: the chain's
    ``set_nb_level`` swaps it).  State: the last ``avg_win`` (coarse path) or ``avg_win - 1``
    (exact path) raw input samples, so the moving average is
    streaming-exact at block joins; the widening windows treat each block
    on its own, as the reference does with each buffer."""

    limit: torch.Tensor
    avg_win: int
    kwidth: int
    pool: int = 1

    @classmethod
    def create(cls, sample_rate: float, level: int = 2,
               half_window_us: float = 500.0, avg_win: int = 64,
               device=None):
        device = resolve_device(device)
        H = max(1, int(half_window_us * 1e-6 * sample_rate))
        # coarse-grid factor: the largest power of two that keeps >= 24
        # coarse half-window taps and divides avg_win.  48 kHz -> 1 (exact
        # path); 192 kHz -> 4; 960 kHz -> 16
        P = 1
        while P < 16 and (H // (2 * P)) >= 24 and avg_win % (2 * P) == 0:
            P *= 2
        return cls(limit=cls.level_limit(level, device), avg_win=avg_win,
                   kwidth=2 * H + 1, pool=P)

    @staticmethod
    def level_limit(level: int, device) -> torch.Tensor:
        """Threshold of level 1/2/3 (quisk.c:716-727)."""
        return torch.tensor({1: 6.0, 2: 4.0, 3: 2.5}[int(level)],
                            dtype=torch.float32, device=device)

    def init_state(self, channels: int):
        w = self.avg_win if self.pool > 1 else self.avg_win - 1
        return torch.zeros((channels, w), dtype=torch.complex64,
                           device=self.limit.device)

    def __call__(self, hist, x: torch.Tensor):
        if self.pool > 1 and x.shape[-1] % self.pool == 0:
            return self._coarse(hist, x)
        return self._exact(hist, x)

    def detect(self, hist, x: torch.Tensor):
        """Coarse-path detection without applying: (new_hist, gain
        [C, B/pool]) on the pool:1 grid.  Only valid when ``pool > 1``."""
        if self.pool == 1:
            raise ValueError("detect() requires the coarse path (pool>1)")
        return self._coarse_gain(hist, x)

    def _coarse(self, hist, x: torch.Tensor):
        new_hist, gc = self._coarse_gain(hist, x)
        C, B = x.shape
        P = self.pool
        # linear upsample of the gain back to the raw grid
        nxt = torch.cat([gc[:, 1:], gc[:, -1:]], dim=-1)
        w = (torch.arange(P, dtype=torch.float32, device=x.device) / P)
        g = (gc[..., None] * (1.0 - w) + nxt[..., None] * w).reshape(C, B)
        return new_hist, x * g

    def _coarse_gain(self, hist, x: torch.Tensor):
        C, B = x.shape
        P = self.pool
        W = self.avg_win // P                    # box window in groups
        GB = B // P
        xs = torch.cat([hist, x], dim=-1)        # [C, B + avg_win]
        mg = torch.abs(xs).reshape(C, xs.shape[-1] // P, P)
        S = mg.sum(-1)                           # group sums
        X = mg.max(-1).values                    # group maxes
        # trailing moving average over avg_win raw samples, per x-group
        acc = S[:, W:]
        for k in range(1, W):
            acc = acc + S[:, W - k: W - k + GB]
        thr = self.limit * torch.clamp(acc * (1.0 / self.avg_win), min=1e-12)
        pc = (X[:, W:] > thr).to(torch.float32)
        HC = (self.kwidth // 2) // P
        pz = torch.nn.functional.pad(pc, (HC, HC))
        rc = torch.as_tensor(raised_cosine(2 * HC + 1), device=x.device)
        pwc = sliding_dot(pz, rc, GB)
        gc = torch.clamp(1.0 - pwc, 0.0, 1.0)    # [C, GB]
        return xs[:, xs.shape[-1] - self.avg_win:], gc

    def _exact(self, hist, x: torch.Tensor):
        B = x.shape[-1]
        A = self.avg_win
        hist = hist[:, hist.shape[-1] - (A - 1):]
        xe = torch.cat([hist, x], dim=-1)
        mag = torch.abs(xe)
        box = torch.full((A,), 1.0 / A, dtype=torch.float32, device=x.device)
        avg = sliding_dot(mag, box, B)
        pulse = (mag[:, A - 1:] > self.limit * torch.clamp(avg, min=1e-12)
                 ).to(torch.float32)
        # widen the pulse with the raised-cosine kernel: 'same' centred
        # alignment, zero-padded edges
        K = self.kwidth
        pz = torch.nn.functional.pad(pulse, ((K - 1) // 2, (K - 1) // 2))
        pw = sliding_dot(pz, torch.as_tensor(raised_cosine(K), device=x.device),
                         B)
        gain = torch.clamp(1.0 - pw, 0.0, 1.0)
        return xe[:, xe.shape[-1] - (A - 1):], x * gain


def _median(v: torch.Tensor) -> torch.Tensor:
    """Median along the last axis, [C, 1]; an even count averages the two
    middle values (``torch.median`` would take the lower)."""
    s = torch.sort(v, dim=-1).values
    n = v.shape[-1]
    return ((s[:, (n - 1) // 2] + s[:, n // 2]) * 0.5)[:, None]


@dataclasses.dataclass(frozen=True)
class AutoNotch:
    """Automatic multi-tone notch on real audio blocks.

    Tracks a smoothed power spectrum per channel, finds up to ``n_notch``
    persistent peaks, builds a windowed notch FIR in the frequency domain
    each block (data only) and applies it overlap-save style.

    State: (ema spectrum [C, F], input history [C, T-1])."""

    window: torch.Tensor                 # [T] FIR design window
    depth_bins: int
    n_notch: int
    block: int
    nfft: int
    ntaps: int
    ema: float
    snr_open: float

    @classmethod
    def create(cls, block: int, ntaps: int | None = None, n_notch: int = 2,
               width_bins: int = 4, ema: float = 0.7,
               snr_open_db: float = 12.0, device=None):
        """``snr_open_db`` is the peak-over-median threshold that opens a
        notch, calibrated for the ~2x-block analysis window [previous tail
        | block] (a block-length detector needs ~3 dB more)."""
        device = resolve_device(device)
        if ntaps is None:
            # notch depth needs FIR resolution finer than the notch width:
            # a block-length filter (quisk.c:910-949 designs at its FFT size)
            ntaps = block + 1
        nfft = 1 << (block + ntaps - 1 - 1).bit_length()
        w = np.hanning(ntaps).astype(np.float32)
        return cls(window=torch.as_tensor(w, device=device),
                   depth_bins=width_bins, n_notch=n_notch, block=block,
                   nfft=nfft, ntaps=ntaps, ema=ema,
                   snr_open=10 ** (snr_open_db / 10.0))

    def init_state(self, channels: int):
        dev = self.window.device
        return (torch.zeros((channels, self.nfft // 2 + 1),
                            dtype=torch.float32, device=dev),
                torch.zeros((channels, self.ntaps - 1), dtype=torch.float32,
                            device=dev))

    def notch_mask(self, spec: torch.Tensor) -> torch.Tensor:
        """The brick mask [C, F]: 0 within ``depth_bins`` of each peak that
        stands ``snr_open`` over the median (taken on every 4th bin), with
        reflection at DC and Nyquist; 1 elsewhere."""
        C, F = spec.shape
        med = _median(spec[:, ::4]) + 1e-20
        mask = torch.ones_like(spec)
        s = spec
        f = torch.arange(F, device=spec.device)[None, :]
        w = self.depth_bins
        for _ in range(self.n_notch):
            k = torch.argmax(s, dim=-1, keepdim=True)
            peaky = torch.gather(s, 1, k) > self.snr_open * med
            hit = ((torch.abs(f - k) <= w) | (f + k <= w)
                   | (2 * (F - 1) - f - k <= w)) & peaky
            keep = 1.0 - hit.to(torch.float32)
            mask = mask * keep
            s = s * keep
        return mask

    def _design(self, spec: torch.Tensor) -> torch.Tensor:
        """[C, F] complex response of the notch FIR: brick mask ->
        windowed FIR -> the response actually applied."""
        mask = self.notch_mask(spec)
        h = torch.fft.irfft(torch.complex(mask, torch.zeros_like(mask)),
                            n=self.nfft, dim=-1)
        h = torch.roll(h, self.ntaps // 2, dims=-1)[:, : self.ntaps]
        return torch.fft.rfft(h * self.window, n=self.nfft, dim=-1)

    def __call__(self, state, a: torch.Tensor):
        spec_ema, hist = state
        xe = torch.cat([hist, a], dim=-1)
        X = torch.fft.rfft(xe, n=self.nfft, dim=-1)
        # the detection spectrum reuses the apply-pass FFT: xe spans
        # [previous tail | block], as good an estimator of persistent tones
        spec_ema = (self.ema * spec_ema
                    + (1.0 - self.ema) * (X.real * X.real + X.imag * X.imag))
        y = torch.fft.irfft(X * self._design(spec_ema), n=self.nfft, dim=-1)
        y = y[:, self.ntaps - 1: self.ntaps - 1 + self.block]
        return (spec_ema, xe[:, xe.shape[-1] - (self.ntaps - 1):]), y


@dataclasses.dataclass(frozen=True)
class SpectralNoiseBlanker:
    """Spectral noise blanker: excise impulse energy in the STFT domain
    (parity wdsp/snb.c — detect and interpolate corrupted bins).

    Impulses are broadband: a frame whose broadband power jumps far above
    the tracked background is flagged, the flag is dilated one frame each
    way (the window-attenuated halves of a straddling hit are too weak to
    trip the detector but strong enough to click), and flagged frames'
    spectra are replaced by the last clean frame's, so carriers and voice
    running through the hit survive where a time blanker would notch them.
    sqrt-Hann STFT at 50% overlap, ``torch.fft``.  The background tracker is
    a per-frame loop (ops/scanutil.py); the substitution is a gather by the
    index of the last clean frame.

    State: (in_tail [C, H], out_tail [C, H], bg_power [C], prev frame
    flagged [C], last clean spectrum re, im [C, F]), H = fft/2, F = H+1."""

    window: torch.Tensor
    fft: int
    block: int
    k_detect: float
    bg_rate: float

    @classmethod
    def create(cls, block: int, fft: int = 256, k_detect: float = 8.0,
               bg_rate: float = 0.05, device=None):
        device = resolve_device(device)
        if block % (fft // 2):
            raise ValueError("block must be a multiple of fft/2")
        w = np.sqrt(np.hanning(fft + 1)[:fft]).astype(np.float32)
        return cls(window=torch.as_tensor(w, device=device), fft=fft,
                   block=block, k_detect=float(k_detect),
                   bg_rate=float(bg_rate))

    def init_state(self, channels: int):
        H, F = self.fft // 2, self.fft // 2 + 1
        dev = self.window.device

        def z(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=dev)
        # the background starts high and falls onto the clean level:
        # starting low would flag every frame and never update
        return (z(channels, H), z(channels, H),
                torch.full((channels,), 1e6, dtype=torch.float32,
                           device=dev),
                z(channels), z(channels, F), z(channels, F))

    def _track(self, bg: torch.Tensor, pw: torch.Tensor):
        """Frame powers pw [C, nfrm] -> (bg', flags [C, nfrm], the
        background each frame was held against [C, nfrm])."""
        def frame_step(bg, p):
            bad = (p > self.k_detect * bg).to(torch.float32)
            # the background tracks only clean frames: it rises slowly
            # (impulse tails must not lift it) and falls fast (so the high
            # initial value converges within ~20 frames)
            rate = torch.where(p > bg, self.bg_rate, 0.5)
            return torch.where(bad > 0, bg, bg + rate * (p - bg)), (bad, bg)

        bg, (badf, seen) = time_scan(frame_step, bg, pw, dim=1)
        return bg, badf, seen

    def _spectra(self, in_tail, a: torch.Tensor):
        """(ext, frame spectra as (re, im) [C, nfrm, F, 2], frame powers
        [C, nfrm])."""
        ext = torch.cat([in_tail, a], dim=-1)
        X = torch.fft.rfft(_frames(ext, self.fft // 2) * self.window, dim=-1)
        Xri = torch.view_as_real(X)
        pw = torch.mean(Xri[..., 0] * Xri[..., 0] + Xri[..., 1] * Xri[..., 1],
                        dim=-1)
        return ext, Xri, pw

    def frame_ratio(self, state, a: torch.Tensor) -> torch.Tensor:
        """The detector's p / (k_detect * bg) for each frame of the block
        [C, nfrm]: a frame is flagged where it exceeds 1."""
        _, _, pw = self._spectra(state[0], a)
        _, _, seen = self._track(state[2], pw)
        return pw / (self.k_detect * seen)

    def __call__(self, state, a: torch.Tensor):
        in_tail, out_tail, bg, prev_bad, clean_re, clean_im = state
        H = self.fft // 2
        ext, Xri, pw = self._spectra(in_tail, a)
        bg, badf, _ = self._track(bg, pw)
        # dilate one frame each way (frame 0's backward edge is the
        # previous block's last flag)
        left = torch.cat([prev_bad[:, None], badf[:, :-1]], dim=-1)
        right = torch.cat([badf[:, 1:], badf[:, -1:]], dim=-1)
        dil = torch.maximum(badf, torch.maximum(left, right))
        # a flagged frame takes the spectrum of the last clean frame before
        # it: index 0 is the carried clean spectrum, frame t is t+1
        nfrm = dil.shape[-1]
        pos = torch.arange(1, nfrm + 1, device=a.device).expand_as(dil)
        last = torch.cummax(torch.where(dil > 0, 0, pos), dim=-1).values
        spec = torch.cat([torch.stack([clean_re, clean_im], dim=-1)[:, None],
                          Xri], dim=1)                      # [C, 1+nfrm, F, 2]
        idx = last[:, :, None, None].expand(-1, -1, *spec.shape[2:])
        Y = torch.gather(spec, 1, idx)
        clean = Y[:, -1]
        y = torch.fft.irfft(torch.view_as_complex(Y.contiguous()), n=self.fft,
                            dim=-1) * self.window
        out, new_out_tail = _overlap_add(y, out_tail)
        return (ext[:, ext.shape[-1] - H:], new_out_tail, bg, badf[:, -1],
                clean[..., 0], clean[..., 1]), out
