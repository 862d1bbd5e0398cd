"""Rate changers: the half-band decimate-by-2, the polyphase
interpolator and the fractional (Lagrange) decimator.

:class:`HalfbandDecim2` is the 45-tap half-band /2 (filter.c:377-417) as a
strided FIR.  :class:`Interpolator` zero-stuffs by L and image-rejects as
one banded polyphase fp32 matmul (filter.c:131-321, wdsp/resample.c).
For a rational ratio M/L the read position of output n is n*M/L: its
integer part advances in a pattern of period L and its fraction cycles
through L phases, so the weights are a constant [n_out, 4] table and the
stage is a static gather plus a length-4 inner product (quisk.c:579-678
``cFracDecim``, with exact rational phase bookkeeping).
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction

import numpy as np
import torch

from quisk_tpu_torch._device import resolve_device
from quisk_tpu_torch.ops import design
from quisk_tpu_torch.ops.fir import ConvFIR


@dataclasses.dataclass(frozen=True)
class HalfbandDecim2:
    """Decimate-by-2 half-band FIR (default 45 taps / ~120 dB)."""

    fir: ConvFIR

    @classmethod
    def create(cls, block: int, ntaps: int = 45, atten_db: float = 120.0,
               complex_state: bool = True, device=None):
        taps = design.halfband(ntaps, atten_db)
        return cls(fir=ConvFIR.create(taps, block, decim=2,
                                      complex_state=complex_state,
                                      device=device))

    @property
    def block(self):
        return self.fir.block

    def init_state(self, channels: int):
        return self.fir.init_state(channels)

    def __call__(self, state, x):
        return self.fir(state, x)


@dataclasses.dataclass(frozen=True)
class Interpolator:
    """Integer upsampler: zero-stuff by L, then the image-reject FIR, as one
    banded polyphase matmul.  Output phase p is a FIR of the input-rate
    signal with the taps h[p::L]; all L phases share the overlapping
    patches xe[iR : iR + R + S] of the history-extended block, so the
    upsample is patches [C, B/R, R+S] x M [R+S, R*L], column r*L + p
    holding phase p's reversed taps at row offset r; the row-major reshape
    of the product interleaves the phases back into time order.  fp32,
    no TF32.

    State: the last ``_span`` input samples (complex64 [C, span], or
    float32 when ``complex_state`` is False)."""

    M: torch.Tensor                # [R+S, R*L] float32
    interp: int
    ntaps: int
    block: int
    R: int
    complex_state: bool = True

    @classmethod
    def create(cls, interp: int, block: int, fs_out: float,
               atten_db: float = 90.0, complex_state: bool = True,
               device=None):
        device = resolve_device(device)
        taps = design.interpolator(interp, fs_out, atten_db)
        T, L = len(taps), interp
        S = -(-(T - 2) // L) + 1                       # history span
        R = 128
        while block % R:
            R //= 2
        Td = S + 1                                     # phase-kernel reach
        # y[(iR+r)L + p] = sum_d h[L(Td-2-d) + p + 1] * xe[iR + r + d]
        M = np.zeros((R + S, R * L), np.float32)
        r = np.arange(R)
        for p in range(L):
            for d in range(Td):
                j = L * (Td - 2 - d) + p + 1
                if 0 <= j < T:
                    M[r + d, r * L + p] = taps[j]
        return cls(M=torch.as_tensor(M, device=device), interp=interp,
                   ntaps=T, block=block, R=R, complex_state=complex_state)

    @property
    def _span(self) -> int:
        # history so that the zero-stuffed valid FIR yields block*interp
        # outputs: (span-1)*interp >= ntaps-2
        return -(-(self.ntaps - 2) // self.interp) + 1

    def init_state(self, channels: int):
        dt = torch.complex64 if self.complex_state else torch.float32
        return torch.zeros((channels, self._span), dtype=dt,
                           device=self.M.device)

    def _matmul_up(self, xe: torch.Tensor) -> torch.Tensor:
        K = self.M.shape[0]
        if xe.is_complex():
            C = xe.shape[0]
            lhs = torch.cat([xe.real, xe.imag], dim=0).to(torch.float32)
            y = torch.matmul(lhs.unfold(-1, K, self.R), self.M)
            y = y.reshape(2 * C, -1)
            return torch.complex(y[:C], y[C:])
        y = torch.matmul(xe.to(torch.float32).unfold(-1, K, self.R), self.M)
        return y.reshape(xe.shape[0], -1)

    def __call__(self, hist: torch.Tensor, x: torch.Tensor):
        """x [C, B] -> (hist', y [C, B*interp])."""
        xe = torch.cat([hist, x.to(hist.dtype)], dim=-1)
        return xe[..., xe.shape[-1] - self._span:], self._matmul_up(xe)


def _lagrange4_weights(mu: np.ndarray) -> np.ndarray:
    """Cubic Lagrange weights for fractional offset mu in [0, 1) between
    samples 1 and 2 of a 4-sample window."""
    m = mu
    w0 = -m * (m - 1.0) * (m - 2.0) / 6.0
    w1 = (m + 1.0) * (m - 1.0) * (m - 2.0) / 2.0
    w2 = -(m + 1.0) * m * (m - 2.0) / 2.0
    w3 = (m + 1.0) * m * (m - 1.0) / 6.0
    return np.stack([w0, w1, w2, w3], axis=-1)


@dataclasses.dataclass(frozen=True)
class FracDecim:
    """Rational fractional decimator by M/L (output rate = input * L / M)."""

    weights: torch.Tensor                                 # [n_out, 4] f32
    gather_idx: torch.Tensor                              # [n_out, 4] int64
    ratio_num: int
    ratio_den: int
    block: int
    n_out: int
    hist_len: int

    @classmethod
    def create(cls, ratio: Fraction | float, block: int, device=None):
        """ratio = input_rate / output_rate (> 1 decimates), e.g. 25/24."""
        device = resolve_device(device)
        r = Fraction(ratio).limit_denominator(1 << 16)
        M, L = r.numerator, r.denominator
        if (block * L) % M:
            raise ValueError(f"block {block} must make block*L divisible by M "
                             f"(M={M}, L={L})")
        n_out = block * L // M
        # output n reads at n*M/L - 1 (one-sample latency): a window of
        # stream samples floor-1 .. floor+2, with 3 samples of history
        num = np.arange(n_out, dtype=np.int64) * M
        ip = num // L
        mu = (num - ip * L).astype(np.float64) / L
        hist_len = 3
        idx = (ip + hist_len - 2)[:, None] + np.arange(4)[None, :]
        w = _lagrange4_weights(mu).astype(np.float32)
        return cls(weights=torch.as_tensor(w, device=device),
                   gather_idx=torch.as_tensor(idx, device=device),
                   ratio_num=M, ratio_den=L, block=block, n_out=n_out,
                   hist_len=hist_len)

    def init_state(self, channels: int):
        return torch.zeros((channels, self.hist_len), dtype=torch.complex64,
                           device=self.weights.device)

    def __call__(self, hist: torch.Tensor, x: torch.Tensor):
        xe = torch.cat([hist, x.to(torch.complex64)], dim=-1)
        win = xe[:, self.gather_idx]                      # [C, n_out, 4]
        y = torch.einsum("cnk,nk->cn", win,
                         self.weights.to(torch.complex64))
        return xe[..., xe.shape[-1] - self.hist_len:], y
