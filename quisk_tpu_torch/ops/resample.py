"""Fractional (Lagrange) decimator.

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
