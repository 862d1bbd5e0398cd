"""Noise reduction: spectral MMSE noise reduction (NR2), the block-LMS
adaptive predictor (ANR / ANF), and the synchronous AM demodulator.

Counterparts of ``quisk_tpu.ops.nr`` ``SpectralNR``, ``BlockLMS`` and
``SyncAMDemod``.

- emnr.c: Ephraim-Malah spectral noise reduction — an STFT (sqrt-Hann,
  50% overlap-add) with a decision-directed a-priori SNR estimator and the
  MMSE-LSA gain evaluated directly through a rational E1 approximation
  (the reference WDSP precomputes gain tables instead).
- anr.c / anf.c: LMS adaptive noise reduction / auto-notch — a block-LMS
  adaptive linear predictor; the prediction is the tonal (correlated)
  part: ANF subtracts it, ANR keeps it.

The per-frame noise tracker (8 frames per 2048-sample block) and the
per-sub-block weight update (4 per block) are sequential in time and run
as Python loops with the state vectorised over channels
(ops/scanutil.py).  Transforms are ``torch.fft``.  The sync-AM PLL is
per sample: it runs in the PLL kernel (ops/pll.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from quisk_tpu_torch._device import resolve_device
from quisk_tpu_torch.ops.pll import pll_sync_am
from quisk_tpu_torch.ops.scanutil import time_scan


def exp1(v: torch.Tensor) -> torch.Tensor:
    """Exponential integral E1(v), v > 0 — Abramowitz & Stegun 5.1.53
    (v <= 1, polynomial, |err| < 2e-7) / 5.1.56 (v >= 1, rational,
    |err| < 2e-8)."""
    v = torch.clamp(v, min=1e-10)
    small = v <= 1.0
    one = torch.ones_like(v)
    vs = torch.where(small, v, one)
    poly = (-0.57721566 + vs * (0.99999193 + vs * (-0.24991055 + vs * (
        0.05519968 + vs * (-0.00976004 + vs * 0.00107857)))))
    e1_small = -torch.log(vs) + poly
    vl = torch.where(small, one, v)
    num = (((vl + 8.5733287401) * vl + 18.059016973) * vl
           + 8.6347608925) * vl + 0.2677737343
    den = (((vl + 9.5733223454) * vl + 25.6329561486) * vl
           + 21.0996530827) * vl + 3.9584969228
    e1_large = torch.exp(-vl) / vl * (num / den)
    return torch.where(small, e1_small, e1_large)


def _frames(ext: torch.Tensor, H: int) -> torch.Tensor:
    """50%-overlap frames [C, nfrm, 2H] of ext [C, (nfrm+1)*H]."""
    tiles = ext.reshape(ext.shape[0], -1, H)
    return torch.cat([tiles[:, :-1], tiles[:, 1:]], dim=-1)


def _overlap_add(y: torch.Tensor, out_tail: torch.Tensor):
    """Frames y [C, nfrm, 2H] -> (audio [C, nfrm*H], new tail [C, H]):
    output tile t = first half of frame t + second half of frame t-1."""
    C, nfrm, fft = y.shape
    H = fft // 2
    pad = torch.nn.functional.pad
    out_tiles = pad(y[:, :, :H], (0, 0, 0, 1)) + pad(y[:, :, H:],
                                                     (0, 0, 1, 0))
    out_tiles[:, 0] += out_tail
    out = out_tiles.reshape(C, (nfrm + 1) * H)
    return out[:, : nfrm * H], out[:, nfrm * H:]


@dataclasses.dataclass(frozen=True)
class SpectralNR:
    """MMSE-LSA spectral noise reduction on real audio ``[C, block]``.

    STFT with sqrt-Hann analysis/synthesis windows at 50% overlap; noise
    PSD tracked by an exponential quantile tracker on the time-smoothed
    PSD; a-priori SNR by the decision-directed rule; spectral gain
    G = xi/(1+xi) * exp(E1(v)/2).

    State: (in_tail [C, H], out_tail [C, H], noise_psd [C, F], prev_s2
    [C, F], psd_ema [C, F]) with H = fft/2 and F = fft/2+1."""

    window: torch.Tensor          # [fft] sqrt-Hann
    fft: int
    block: int
    alpha: float                  # decision-directed weight
    noise_up: float               # noise PSD rise rate
    noise_down: float
    gain_floor: float

    @classmethod
    def create(cls, block: int, fft: int = 512, alpha: float = 0.98,
               gain_floor_db: float = -18.0, device=None):
        device = resolve_device(device)
        if block % (fft // 2):
            raise ValueError("block must be a multiple of fft/2")
        w = np.sqrt(np.hanning(fft + 1)[:fft]).astype(np.float32)
        # the tracker's equilibrium (p_below ln(down) + p_above ln(up) = 0)
        # sits near the 30th percentile of the smoothed PSD; the gain's
        # bias factor maps that to the mean
        return cls(window=torch.as_tensor(w, device=device), fft=fft,
                   block=block, alpha=alpha, noise_up=1.008, noise_down=0.98,
                   gain_floor=10 ** (gain_floor_db / 20.0))

    def init_state(self, channels: int):
        H, F = self.fft // 2, self.fft // 2 + 1
        dev = self.window.device

        def z(n):
            return torch.zeros((channels, n), dtype=torch.float32, device=dev)
        # the noise estimate starts high and falls fast: starting low
        # would take seconds to climb
        return (z(H), z(H), torch.full((channels, F), 10.0,
                                       dtype=torch.float32, device=dev),
                z(F), z(F))

    def _frame_gain(self, S2, noise_psd, prev_s2):
        """Per-frame MMSE-LSA gain.  noise_psd is the quantile track; x2
        corrects it to the mean noise power and a further 1.25x
        over-subtracts."""
        noise_psd = torch.clamp(2.5 * noise_psd, min=1e-12)
        gamma = torch.clamp(S2 / noise_psd, 1e-4, 1e2)
        xi = (self.alpha * prev_s2 / noise_psd
              + (1.0 - self.alpha) * torch.clamp(gamma - 1.0, min=0.0))
        xi = torch.clamp(xi, 1e-4, 1e2)
        r = xi / (1.0 + xi)
        g = r * torch.exp(0.5 * exp1(torch.clamp(r * gamma, 1e-10, 700.0)))
        return torch.clamp(g, min=self.gain_floor)

    def __call__(self, state, a: torch.Tensor):
        in_tail, out_tail, noise_psd, prev_s2, psd_ema = state
        H = self.fft // 2
        ext = torch.cat([in_tail, a], dim=-1)            # [C, H*(nfrm+1)]
        X = torch.fft.rfft(_frames(ext, H) * self.window, dim=-1)
        S2 = torch.abs(X) ** 2                            # [C, nfrm, F]

        def frame_step(carry, s2):
            npsd, ps2, pema = carry
            pema = 0.8 * pema + 0.2 * s2                  # smooth the PSD
            npsd = torch.where(pema < npsd, npsd * self.noise_down,
                               npsd * self.noise_up)
            npsd = torch.minimum(npsd, pema + 1e-12)
            g = self._frame_gain(s2, npsd, ps2)
            return (npsd, g ** 2 * s2, pema), g

        (noise_psd, prev_s2, psd_ema), gains = time_scan(
            frame_step, (noise_psd, prev_s2, psd_ema), S2, dim=1)
        y = torch.fft.irfft(X * gains, n=self.fft, dim=-1) * self.window
        audio, new_out_tail = _overlap_add(y, out_tail)
        return (ext[:, ext.shape[-1] - H:], new_out_tail, noise_psd, prev_s2,
                psd_ema), audio


@dataclasses.dataclass(frozen=True)
class BlockLMS:
    """Normalised block-LMS adaptive linear predictor.

    Predicts sample n from samples [n-delay-taps+1 .. n-delay].  Tonal
    interference is predictable across the decorrelation delay; noise and
    voice are not.  ``notch=True`` outputs input - prediction (ANF,
    wdsp/anf.c); ``notch=False`` outputs the prediction (ANR, wdsp/anr.c).

    Weights update once per ``sub`` samples.  ``fdaf`` runs prediction and
    gradient as rFFT products (overlap-save fast block LMS, Shynk 1992:
    exact linear correlation, segment and padding lengths chosen so
    nothing wraps; the gradient is constrained to ``taps`` coefficients);
    otherwise they are [sub, taps] window-matrix products.  Both are the
    same update.  State: (weights [C, taps], input tail [C, taps+delay-1]).
    """

    mu: torch.Tensor
    taps: int
    delay: int
    block: int
    sub: int
    notch: bool
    leak: float
    fdaf: bool = True

    @classmethod
    def create(cls, block: int, taps: int = 256, delay: int = 16,
               mu: float = 2.0, notch: bool = True, leak: float = 1e-5,
               sub: int = 512, fdaf: bool = True, device=None):
        device = resolve_device(device)
        # larger sub-blocks average the NLMS gradient over more samples;
        # shrink to fit small blocks
        while sub > 1 and block % sub:
            sub //= 2
        return cls(mu=torch.tensor(mu, dtype=torch.float32, device=device),
                   taps=taps, delay=delay, block=block, sub=sub, notch=notch,
                   leak=leak, fdaf=fdaf)

    def init_state(self, channels: int):
        dev = self.mu.device
        return (torch.zeros((channels, self.taps), dtype=torch.float32,
                            device=dev),
                torch.zeros((channels, self.taps + self.delay - 1),
                            dtype=torch.float32, device=dev))

    def _predict_time(self, s, w, blk):
        """Window-matrix form: win[i, k] = s[taps-1+i-k]."""
        win = s.unfold(-1, self.taps, 1).flip(-1)          # [C, sub, taps]
        pred = torch.einsum("cik,ck->ci", win, w)
        err = blk - pred
        return pred, err, torch.einsum("ci,cik->ck", err, win)

    def _predict_fdaf(self, s, w, blk):
        N = 1 << (s.shape[-1] - 1).bit_length()
        Sf = torch.fft.rfft(s, n=N, dim=-1)
        pred = torch.fft.irfft(Sf * torch.fft.rfft(w, n=N, dim=-1), n=N,
                               dim=-1)[:, self.taps - 1:
                                       self.taps - 1 + self.sub]
        err = blk - pred
        # z[n] = sum_m s[m+n] err[m]  (linear: P-1 + sub-1 < N)
        z = torch.fft.irfft(Sf * torch.conj(torch.fft.rfft(err, n=N, dim=-1)),
                            n=N, dim=-1)
        return pred, err, z[:, : self.taps].flip(-1)

    def __call__(self, state, a: torch.Tensor):
        w0, tail = state
        C = a.shape[0]
        hist = self.taps + self.delay - 1
        P = self.taps + self.sub - 1           # prediction input segment
        predict = self._predict_fdaf if self.fdaf else self._predict_time

        def step(carry, blk):
            w, tl = carry
            ext = torch.cat([tl, blk], dim=-1)             # [C, hist+sub]
            pred, err, corr = predict(ext[:, :P], w, blk)
            # NLMS: normalise by ||u||^2 ~ taps * mean power, keeping the
            # effective step ~ mu whatever the level or tap count
            power = self.taps * torch.mean(ext ** 2, dim=-1) + 1e-8
            w = ((1.0 - self.leak) * w
                 + self.mu * (corr / self.sub) / power[:, None])
            return (w, ext[:, ext.shape[-1] - hist:]), (err if self.notch
                                                        else pred)

        (w, tail), outs = time_scan(
            step, (w0, tail), a.reshape(C, self.block // self.sub, self.sub),
            dim=1)
        return (w, tail), outs.reshape(C, self.block)


@dataclasses.dataclass(frozen=True)
class SyncAMDemod:
    """Synchronous AM: a second-order PLL locks to the carrier, audio is the
    in-phase projection less its tracked DC (parity: wdsp/amd.c PLL mode).

    State: (phase [C], freq [C] rad/sample, dc [C]).  The loop runs in
    the PLL kernel's sync-AM mode (ops/pll.py)."""

    alpha: torch.Tensor       # phase gain
    beta: torch.Tensor        # freq gain
    dc_pole: torch.Tensor
    max_freq: torch.Tensor    # rad/sample clamp

    @classmethod
    def create(cls, sample_rate: float, bw_hz: float = 100.0,
               max_offset_hz: float = 2000.0, device=None):
        device = resolve_device(device)
        # standard 2nd-order loop, damping 0.707
        wn = 2.0 * np.pi * bw_hz / sample_rate

        def f32(v):
            return torch.tensor(np.float32(v), device=device)

        return cls(alpha=f32(2.0 * 0.707 * wn), beta=f32(wn * wn),
                   dc_pole=f32(0.9995),
                   max_freq=f32(2 * np.pi * max_offset_hz / sample_rate))

    def init_state(self, channels: int):
        z = torch.zeros((channels,), dtype=torch.float32,
                        device=self.alpha.device)
        return (z, z, z)

    def coef(self) -> torch.Tensor:
        """The PLL kernel's (alpha, beta, max_freq, dc_pole)."""
        return torch.stack([self.alpha, self.beta, self.max_freq,
                            self.dc_pole])

    def __call__(self, state, x: torch.Tensor):
        return pll_sync_am(x, tuple(state), self.coef())
