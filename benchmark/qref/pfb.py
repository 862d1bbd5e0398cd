"""Plain reference of the PFB channelizer receiver, in float64, from the
configuration and the input blocks alone.

Channel ``c`` of ``K`` is the wideband stream mixed down by
``e^{-2 pi i c s / K}`` (``s`` the stream sample), filtered by the
prototype lowpass ``h`` of ``P*K`` taps, and kept at the end of every hop
of ``M = K/2`` samples:

    y_c[m] = sum_j h[j] x[(m+1) M - 1 - j] e^{-2 pi i c ((m+1) M - 1 - j) / K}

which, with the window ``w_m[i] = x[(m+1) M - P K + i]``, is
``(-1)^(c (m+1))`` times the forward K-point DFT of the branch sums
``sum_p h[P K - 1 - (p K + r)] w_m[p K + r]``.  The power row of a block
is the mean of ``|y_c|^2`` over its frames; the audio of a listened
channel is its family's demodulator at the channel rate (SSB ``2 Re y``,
AM ``2`` times the DC-blocked envelope with pole 0.995, FM the gated
phase-difference discriminator times ``rate / (2 pi deviation)`` through
the 300 Hz de-emphasis pole).

Block ``k`` is replayed, with every state at zero, from as many blocks
back as hold 6000 frames (one at the receiver's 16384 frames a block):
the window reaches ``P*K`` samples back and the AM pole leaves
0.995^6000 ~ 9e-14 of a wrong start, so block ``k`` comes out whole.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from qref import design, ops
from qref.spec import FAMILY, pfb_modes
from qref.tf32 import round_tf32

SETTLE = 6000              # frames for a zero start to settle
SUPPORTED = {"n_chan", "block", "channel_rate", "taps_per_branch",
             "atten_db", "fm_deviation_hz", "pallas_poly", "pallas_demod",
             "with_spectrum"}


@dataclasses.dataclass
class PfbReference:
    K: int
    P: int
    block_in: int
    h: np.ndarray                  # float64 [P*K]
    family: np.ndarray             # per channel
    fm_gain: float
    de_a: float
    dc_a: float = 0.995
    device: str = "cpu"

    @classmethod
    def create(cls, cfg: dict, device="cpu") -> "PfbReference":
        p = cfg["pipeline"]
        extra = set(p) - SUPPORTED
        if extra:
            raise ValueError(f"the reference has no stage for {sorted(extra)}")
        if not p.get("with_spectrum", True):
            raise ValueError("the reference compares the power row")
        K, P = p["n_chan"], p.get("taps_per_branch", 8)
        rate = float(p["channel_rate"])
        return cls(K=K, P=P, block_in=p["block"],
                   h=design.pfb_prototype(K, P, p.get("atten_db", 90.0)),
                   family=np.array([FAMILY[m] for m in pfb_modes(cfg)]),
                   fm_gain=rate / (2.0 * np.pi
                                   * p.get("fm_deviation_hz", 5000.0)),
                   de_a=float(np.exp(-2.0 * np.pi * 300.0 / rate)),
                   device=str(device))

    @property
    def n_out(self) -> int:
        return 2 * self.block_in // self.K

    def _channels(self, x: torch.Tensor, listen: np.ndarray, first: int,
                  lowp: bool, chunk: int):
        """(y of the listened channels [frames, L] complex128, power row of
        the frames from ``first`` on [K])."""
        K, P = self.K, self.P
        M = K // 2
        ext = torch.cat([torch.zeros(P * K - M, dtype=x.dtype,
                                     device=x.device), x])
        h_rev = torch.as_tensor(self.h[::-1].copy(), device=x.device)
        if lowp:
            ext, h_rev = round_tf32(ext), round_tf32(h_rev)
        frames = x.shape[0] // M
        win = ext.unfold(0, P * K, M)
        odd_c = torch.arange(K, device=x.device) % 2 == 1
        lis = torch.as_tensor(listen, device=x.device)
        ys, power = [], torch.zeros(K, dtype=torch.float64, device=x.device)
        for f0 in range(0, frames, chunk):
            f1 = min(frames, f0 + chunk)
            v = (win[f0:f1] * h_rev).view(f1 - f0, P, K).sum(1)
            if lowp:
                v = round_tf32(v)
            y = torch.fft.fft(v, dim=-1)
            odd_m1 = (torch.arange(f0, f1, device=x.device) + 1) % 2 == 1
            y = torch.where(odd_m1[:, None] & odd_c[None, :], -y, y)
            ys.append(y[:, lis])
            if f1 > first:
                power += (y[max(0, first - f0):].abs() ** 2).sum(0)
        return torch.cat(ys), power / (frames - first)

    def block(self, get_block, k: int, listen: np.ndarray, lowp: bool = False,
              chunk: int = 512) -> tuple[np.ndarray, np.ndarray]:
        """(audio of the listened channels in block ``k`` [L, n_out],
        power row of block ``k`` [K]), float64.  ``get_block(j)`` returns
        input block j [1, block_in] complex64 (any device).  ``lowp``
        computes the control: the window, the taps and the DFT's input
        rounded to TF32."""
        j0 = max(0, k - -(-SETTLE // self.n_out))
        x = torch.cat([get_block(j)[0].to(self.device).to(torch.complex128)
                       for j in range(j0, k + 1)])
        first = (k - j0) * self.n_out
        y, power = self._channels(x, listen, first, lowp, chunk)
        audio = ops.demod(y.T, list(self.family[listen]), self.fm_gain,
                          self.de_a, self.dc_a)
        return audio[:, first:].cpu().numpy(), power.cpu().numpy()
