"""Polyphase filterbank (PFB) channelizer: one wideband capture ->
thousands of uniformly spaced channels in one pass.

Where the per-channel chain pays one NCO and decimation cascade per
channel, the PFB pays one prototype-filter pass plus one FFT across
branches for all K channels.  Structure (the standard DFT filterbank):

  prototype lowpass h of length P*K (P taps per branch, cutoff fs/2K)
  v[m, k] = sum_p h[pK + k] * x[(m - p)K + k']      (polyphase sums)
  y[m, :] = K-point inverse DFT of v[m, :]: channel c centred at c*fs/K

Counterpart of ``quisk_tpu.ops.channelizer``.  The polyphase sums run in
the CUDA kernels of ``ops/pfb_kernels.py`` with ``pallas_poly`` (the flag
names of the JAX package are kept, so a reader finds the counterpart) and
as shifted-view accumulation in torch ops without; the receiver's stage-2
IDFT and demodulators run in the fused kernel with ``pallas_demod`` and as
``torch.fft`` plus :class:`GroupedDemodTM` without.  State is tensors on
the op's device (complex64 history, float32 demod state).  The JAX
package's matmul DFT (``mxu_dft``) is a workaround for a slow FFT on its
hardware and has no counterpart: the cross-branch IDFT of the routes
without the fused kernel is ``torch.fft.ifft``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from scipy import signal as _sig

from quisk_tpu_torch._device import resolve_device
from quisk_tpu_torch.modes import Mode
from quisk_tpu_torch.ops.demod import GroupedDemodTM
from quisk_tpu_torch.ops.pfb_kernels import (K2, pfb_demod_call,
                                             pfb_poly_critical,
                                             pfb_poly_critical_plain,
                                             pfb_poly_oversampled,
                                             pfb_poly_oversampled_plain)
from quisk_tpu_torch.utils.profiling import span


def pfb_prototype(n_chan: int, taps_per_branch: int = 8,
                  atten_db: float = 90.0) -> np.ndarray:
    """Prototype lowpass for a critically-sampled PFB: length P*K, cutoff
    at the channel half-width fs/(2K), unity DC gain."""
    n = n_chan * taps_per_branch
    beta = _sig.kaiser_beta(atten_db)
    h = _sig.firwin(n, 1.0 / n_chan, window=("kaiser", beta))
    return h / h.sum()


def _h_poly(n_chan: int, taps_per_branch: int, atten_db: float, device):
    h = pfb_prototype(n_chan, taps_per_branch, atten_db)
    return torch.as_tensor(h.reshape(taps_per_branch, n_chan).astype(
        np.float32), device=device)


def _idft_ri(n_chan: int, vr: torch.Tensor, vi: torch.Tensor):
    """Cross-branch unnormalised inverse DFT on (re, im) planes."""
    y = torch.fft.ifft(torch.complex(vr, vi), dim=-1) * n_chan
    return y.real, y.imag


def _new_hist(hist: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The last ``hist.shape[-1]`` samples of [hist | x]."""
    H = hist.shape[-1]
    if x.shape[-1] >= H:
        return x[:, x.shape[-1] - H:].contiguous()
    return torch.cat([hist, x], dim=-1)[:, x.shape[-1]:].contiguous()


@dataclasses.dataclass(frozen=True)
class PFBChannelizer:
    """x [S, B] complex (B % K == 0) -> y [S, K, B/K] complex.

    Channel c is centred at c * fs / K (c > K/2 aliases to negative
    frequencies, as FFT bins do); each channel streams at fs / K.  State:
    the last (P-1)*K input samples [S, (P-1)*K] complex64."""

    h_poly: torch.Tensor            # [P, K] branch taps
    n_chan: int
    P: int
    block: int
    pallas_poly: bool = False       # branch sums in the CUDA kernel

    @classmethod
    def create(cls, n_chan: int, block: int, taps_per_branch: int = 8,
               atten_db: float = 90.0, pallas_poly: bool = False,
               device=None):
        device = resolve_device(device)
        if block % n_chan:
            raise ValueError("block must be a multiple of n_chan")
        return cls(h_poly=_h_poly(n_chan, taps_per_branch, atten_db, device),
                   n_chan=n_chan, P=taps_per_branch, block=block,
                   pallas_poly=pallas_poly)

    def init_state(self, streams: int):
        return torch.zeros((streams, (self.P - 1) * self.n_chan),
                           dtype=torch.complex64, device=self.h_poly.device)

    def __call__(self, hist, x: torch.Tensor):
        # True streaming convolution, output stride K, T = P*K taps:
        #   y_c[m] = sum_j h[j] x~_c[mK + PK-1 - j],  x~_c = x e^{-2pi i cn/K}
        # and with j = pK + q
        #   v[m, q] = sum_p h[pK+q] * ext[(m + P-1-p)K + (K-1-q)]
        #   y_c[m]  = e^{2pi i c/K} * K * IFFT_q(v[m, :])[c]
        # The leading per-channel phase is the same in every block (the
        # block is a multiple of K).
        K = self.n_chan
        x = x.contiguous()
        poly = pfb_poly_critical if self.pallas_poly \
            else pfb_poly_critical_plain
        v = poly(hist, x, self.h_poly)                  # [S, M, 2, K]
        yr, yi = self.idft_ri(v[:, :, 0], v[:, :, 1])
        ang = (2.0 * np.pi / K) * torch.arange(K, dtype=torch.float32,
                                               device=x.device)
        y = torch.complex(yr, yi) * torch.complex(torch.cos(ang),
                                                  torch.sin(ang))
        return _new_hist(hist, x), y.transpose(1, 2)    # [S, K, M]

    def channel_freqs(self, fs: float) -> np.ndarray:
        """Centre frequency of each output channel (FFT bin order)."""
        return np.fft.fftfreq(self.n_chan, 1.0 / fs)

    def idft_ri(self, vr: torch.Tensor, vi: torch.Tensor):
        return _idft_ri(self.n_chan, vr, vi)


@dataclasses.dataclass(frozen=True)
class OversampledPFB:
    """2x-oversampled polyphase channelizer: x [S, B] -> y [S, K, 2B/K].

    The DFT filterbank of :class:`PFBChannelizer` with hop K/2, so each
    channel streams at 2*fs/K and its full fs/K bandwidth is alias-free.
    The additions: overlapping analysis windows and the per-output-sample
    rotation (-1)^(c*m) of the half-frame time advance.  State: the last
    P*K - K/2 input samples [S, P*K - K/2] complex64."""

    h_poly: torch.Tensor            # [P, K]
    n_chan: int
    P: int
    block: int
    pallas_poly: bool = False       # branch sums in the CUDA kernel

    @classmethod
    def create(cls, n_chan: int, block: int, taps_per_branch: int = 8,
               atten_db: float = 90.0, pallas_poly: bool = False,
               device=None):
        device = resolve_device(device)
        if n_chan % 2 or block % n_chan:
            raise ValueError("need even n_chan and block % n_chan == 0")
        return cls(h_poly=_h_poly(n_chan, taps_per_branch, atten_db, device),
                   n_chan=n_chan, P=taps_per_branch, block=block,
                   pallas_poly=pallas_poly)

    def init_state(self, streams: int):
        K = self.n_chan
        return torch.zeros((streams, self.P * K - K // 2),
                           dtype=torch.complex64, device=self.h_poly.device)

    def poly_stacked(self, hist, x: torch.Tensor):
        """Polyphase accumulation only: (hist, x [S, B]) -> (new_hist, v)
        with v [S, n_out, 2, K] the pre-IDFT branch sums, per frame the
        real row then the imaginary row, commutator reversal applied:
          v[m, q]  = sum_p h[pK+q] * ext[mM + (P-1-p)K + (K-1-q)]
          y_c[m]   = e^{-2pi i c (M-1)/K} * (-1)^{cm} * K * IFFT(v[m])[c]
        with hop M = K/2."""
        x = x.contiguous()
        poly = pfb_poly_oversampled if self.pallas_poly \
            else pfb_poly_oversampled_plain
        return _new_hist(hist, x), poly(hist, x, self.h_poly)

    def poly_ri(self, hist, x: torch.Tensor):
        """:meth:`poly_stacked` as planes: (new_hist, vr, vi), each
        [S, n_out, K] (views of one buffer)."""
        new_hist, v = self.poly_stacked(hist, x)
        return new_hist, v[:, :, 0], v[:, :, 1]

    def idft_ri(self, vr: torch.Tensor, vi: torch.Tensor):
        return _idft_ri(self.n_chan, vr, vi)

    def rotate_tm(self, yr: torch.Tensor, yi: torch.Tensor):
        """Commutator phase corrections on time-major (re, im) planes
        [..., n_out, K]: the constant per-channel history-alignment phase
        and the (-1)^(c*m) half-frame hop parity, from integer parity
        (the float cosine of a large multiple of pi drifts)."""
        K = self.n_chan
        M = K // 2
        n_out = yr.shape[-2]
        c_idx = torch.arange(K, device=yr.device)
        ang0 = (2.0 * np.pi / K) * c_idx.to(torch.float32) * (M - 1)
        rr = torch.cos(ang0)
        ri = -torch.sin(ang0)
        m_idx = torch.arange(n_out, device=yr.device)
        # parity(c*m) = parity(c) * parity(m), formed in float32
        sign = 1.0 - 2.0 * ((m_idx % 2).to(torch.float32)[:, None]
                            * (c_idx % 2).to(torch.float32)[None, :])
        zr = (yr * rr - yi * ri) * sign
        zi = (yr * ri + yi * rr) * sign
        return zr, zi

    def __call__(self, hist, x: torch.Tensor):
        new_hist, vr, vi = self.poly_ri(hist, x)
        yr, yi = self.idft_ri(vr, vi)
        zr, zi = self.rotate_tm(yr, yi)
        return new_hist, torch.complex(zr, zi).transpose(1, 2)  # [S,K,n_out]


@dataclasses.dataclass(frozen=True)
class PFBRxPipeline:
    """Oversampled PFB -> IDFT -> grouped demod, time-major: the demod
    consumes the IDFT's output in its [S, n_out, K] layout, so the
    channel-major complex batch is never formed (the reference's
    channelizer-style multi-RX decimates and demodulates per bank without
    intermediates, quisk.c:2517-2652).

    Outputs per step: audio and the per-channel power [S, K].

    - Torch-op route (``pallas_demod=False``): ``torch.fft.ifft`` across
      branches, the commutator corrections, :class:`GroupedDemodTM`;
      audio [S, n_out, K], channels in IFFT-bin order.
    - Kernel route (``pallas_demod=True``): the IDFT is split K = K1*K2
      with K2 = 128.  Stage 1 is one real fp32 product of the ``[ar; ai]``
      stack with ``w1x`` [2*K1, 2*K1]; stage 2, the commutator
      corrections, the demodulators and the power sum run in the fused
      kernel (``ops/pfb_kernels.pfb_demod_call``).  Audio is
      [S, n_out*K1, K2]: the flat row of one frame holds channel
      ``chan_perm[p]`` at position p (pick channel c at ``chan_pos[c]``);
      the power comes back unpermuted.  State: the [S, 5*K1, K2] carry,
      rows zr, zi, y_de, env, y_dc.
    """

    pfb: OversampledPFB
    demod: GroupedDemodTM
    #: kernel-route constants (None on the torch-op route): (w1x, (twr,
    #: twi), (w2r, w2i), am mask, fm mask), the masks in position order
    kd: tuple | None = None
    with_spectrum: bool = True
    pallas_demod: bool = False
    K1: int = 0
    K2: int = K2
    g_ssb: float = 2.0
    g_am: float = 2.0
    g_fm: float = 1.0
    a_dc: float = 0.0
    a_de: float = 0.0
    b_de: float = 0.0

    @classmethod
    def create(cls, n_chan: int, block: int, mode, channel_rate: float,
               taps_per_branch: int = 8, atten_db: float = 90.0,
               pallas_poly: bool = False, fm_deviation_hz: float = 5000.0,
               with_spectrum: bool = True, pallas_demod: bool = False,
               device=None):
        device = resolve_device(device)
        pfb = OversampledPFB.create(n_chan, block,
                                    taps_per_branch=taps_per_branch,
                                    atten_db=atten_db,
                                    pallas_poly=pallas_poly, device=device)
        demod = GroupedDemodTM.create(mode, sample_rate=channel_rate,
                                      channels=n_chan,
                                      fm_deviation_hz=fm_deviation_hz,
                                      device=device)
        if not pallas_demod:
            return cls(pfb=pfb, demod=demod, with_spectrum=with_spectrum)
        K = n_chan
        K1 = K // K2
        if K % K2 or K1 % 2:
            raise ValueError(f"pallas_demod needs K % {K2} == 0 and an even "
                             f"K/{K2}")
        M = K // 2
        n1 = np.arange(K1)
        n2 = np.arange(K2)
        # inverse-DFT stage bases (unnormalised, = K * ifft) with the
        # commutator rotation e^{-2pi i c (M-1)/K} folded in: it separates
        # over c = c1 + K1*c2 into a per-c1 factor (the twiddle rows) and
        # a per-c2 factor (the w2 columns); the (-1)^(m c) parity is
        # applied in the kernel (it is parity(m)*parity(c1), K1 being even)
        W1 = np.exp(2j * np.pi * np.outer(n1, n1) / K1)         # [n1, c1]
        tw = (np.exp(2j * np.pi * np.outer(n1, n2) / K)         # [c1, n2]
              * np.exp(-2j * np.pi * n1 * (M - 1) / K)[:, None])
        W2 = (np.exp(2j * np.pi * np.outer(n2, n2) / K2)        # [n2, c2]
              * np.exp(-2j * np.pi * n2 * (M - 1) / K2)[None, :])
        # stage 1 as one real product: [ar; ai] stacked along n1 times
        # [[w1r, w1i], [-w1i, w1r]] gives (br | bi) stacked along c1
        w1x = np.block([[W1.real, W1.imag], [-W1.imag, W1.real]])
        # per-channel mode masks at position p = c1*K2 + c2 (channel
        # c = c1 + K1*c2; see chan_perm)
        mvec = np.broadcast_to(np.asarray(mode, np.int32), (K,))
        pos_c = np.arange(K1)[:, None] + K1 * np.arange(K2)[None, :]

        def f32(a):
            return torch.as_tensor(np.ascontiguousarray(a, np.float32),
                                   device=device)

        kd = (f32(w1x), (f32(tw.real), f32(tw.imag)),
              (f32(W2.real), f32(W2.imag)),
              f32(mvec[pos_c] == int(Mode.AM)),
              f32(mvec[pos_c] == int(Mode.FM)))
        return cls(pfb=pfb, demod=demod, kd=kd, with_spectrum=with_spectrum,
                   pallas_demod=True, K1=K1, g_ssb=float(demod.ssb_gain),
                   g_am=float(demod.am_gain), g_fm=float(demod.fm_gain),
                   a_dc=float(demod.am_dc.a), a_de=float(demod.fm_deemph.a),
                   b_de=float(demod.fm_deemph.b))

    @property
    def chan_perm(self) -> np.ndarray:
        """Kernel-route audio layout: position p of a frame's flat row
        holds IFFT-bin channel chan_perm[p]."""
        p = np.arange(self.K1 * self.K2)
        return (p // self.K2) + self.K1 * (p % self.K2)

    @property
    def chan_pos(self) -> np.ndarray:
        """Inverse of chan_perm: channel c sits at position chan_pos[c]."""
        c = np.arange(self.K1 * self.K2)
        return (c % self.K1) * self.K2 + c // self.K1

    def init_state(self, streams: int):
        if self.pallas_demod:
            dm = torch.zeros((streams, 5 * self.K1, self.K2),
                             dtype=torch.float32,
                             device=self.pfb.h_poly.device)
        else:
            dm = self.demod.init_state(self.pfb.n_chan, lead=(streams,))
        return (self.pfb.init_state(streams), dm)

    def stage1(self, v: torch.Tensor) -> torch.Tensor:
        """The kernel route's stage-1 product: v [S, n_out, 2, K] ->
        bb [S, n_out*2*K1, K2], rows (t, re|im, c1)."""
        S, n_out = v.shape[:2]
        av = v.view(S, n_out, 2 * self.K1, self.K2)     # [ar; ai] along n1
        bb = torch.matmul(self.kd[0].T, av)             # "nk,nc->ck"
        return bb.view(S, n_out * 2 * self.K1, self.K2)

    def __call__(self, state, x: torch.Tensor):
        """x [S, B] complex -> ((pfb_st, dm_st), (audio, spec))."""
        pfb_st, dm_st = state
        S = x.shape[0]
        with span("pfb.step"):
            if not self.pallas_demod:
                with span("pfb.poly"):
                    pfb_st, vr, vi = self.pfb.poly_ri(pfb_st, x)
                with span("pfb.dft"):
                    yr, yi = self.pfb.idft_ri(vr, vi)
                    zr, zi = self.pfb.rotate_tm(yr, yi)
                with span("pfb.demod"):
                    dm_st, audio = self.demod(dm_st, zr, zi)  # [S,n_out,K]
                if self.with_spectrum:
                    with span("pfb.power"):
                        spec = (zr * zr + zi * zi).mean(dim=-2)
                else:
                    spec = torch.zeros((S, 1), dtype=torch.float32,
                                       device=x.device)
                return (pfb_st, dm_st), (audio, spec)
            with span("pfb.poly"):
                pfb_st, v = self.pfb.poly_stacked(pfb_st, x)
            n_out = v.shape[1]
            _, (twr, twi), (w2r, w2i), am_m, fm_m = self.kd
            with span("pfb.stage1"):
                bb = self.stage1(v)
            with span("pfb.demod"):
                audio, spec_sum, dm_st = pfb_demod_call(
                    bb, dm_st, twr, twi, w2r, w2i, am_m, fm_m,
                    g_ssb=self.g_ssb, g_am=self.g_am, g_fm=self.g_fm,
                    a_dc=self.a_dc, a_de=self.a_de, b_de=self.b_de)
            if self.with_spectrum:
                with span("pfb.power"):
                    # position c1*K2 + c2 holds channel c1 + K1*c2, so
                    # channel order is the planes' transpose
                    spec = ((spec_sum * (1.0 / n_out)).transpose(1, 2)
                            .reshape(S, -1))
            else:
                spec = torch.zeros((S, 1), dtype=torch.float32,
                                   device=x.device)
        return (pfb_st, dm_st), (audio, spec)
