"""Speech compressor and CESSB overshoot control for the TX path.

The reference clips the mic audio and rounds the clip knee with a
quadratic soft compressor (microphone.c:484-518).  Here that is one
memoryless transfer curve over ``[C, B]``: unity slope below the knee, a
quadratic knee, a hard ceiling.  :class:`OvershootControl` is CESSB
(wdsp/osctrl.c): envelope clip, in-band filter, envelope clip again.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from quisk_tpu_torch._device import resolve_device
from quisk_tpu_torch.ops import design
from quisk_tpu_torch.ops.fir import ConvFIR


@dataclasses.dataclass(frozen=True)
class SoftCompressor:
    """Memoryless soft knee: linear below ``knee``, a quadratic bend that
    reaches slope 0 at ``ceiling``.  ``gain`` (0-dim or [C]) is the drive;
    a channel whose drive is <= 1 passes its audio unchanged."""

    knee: torch.Tensor
    ceiling: torch.Tensor
    gain: torch.Tensor

    @classmethod
    def create(cls, drive_db=6.0, knee: float = 0.5, ceiling: float = 1.0,
               device=None):
        device = resolve_device(device)
        g = 10.0 ** (np.asarray(drive_db, np.float32) / 20.0)
        return cls(knee=torch.tensor(np.float32(knee), device=device),
                   ceiling=torch.tensor(np.float32(ceiling), device=device),
                   gain=torch.as_tensor(np.asarray(g, np.float32),
                                        device=device))

    def init_state(self, channels: int):
        return ()

    def __call__(self, state, a: torch.Tensor):
        gain = self.gain if self.gain.ndim == 0 else self.gain[:, None]
        x = a * gain
        s = torch.sign(x)
        m = torch.abs(x)
        k, c = self.knee, self.ceiling
        # y = k + span*(t - t^2/2), t = (m-k)/span clipped to [0, 1]
        span = 2.0 * (c - k)
        t = torch.clamp((m - k) / span, 0.0, 1.0)
        soft = k + span * (t - 0.5 * t * t)
        y = torch.where(m <= k, m, soft)
        out = s * torch.minimum(y, c)
        return state, torch.where(gain <= 1.0, a, out)


def _env_clip(z: torch.Tensor, ceiling) -> torch.Tensor:
    """Scale complex samples whose envelope exceeds ``ceiling`` back onto
    it (phase kept, so no AM-to-PM distortion)."""
    mag = torch.abs(z)
    scale = torch.clamp(ceiling / torch.clamp(mag, min=1e-12), max=1.0)
    return z * scale.to(z.dtype)


@dataclasses.dataclass(frozen=True)
class OvershootControl:
    """CESSB overshoot control on the analytic TX signal (wdsp/osctrl.c,
    controlled-envelope SSB after W9GR): envelope clip, a linear-phase
    in-band filter that confines the clip's splatter, envelope clip again,
    and a last trim at 1.02 x ceiling.

    State: (fir1 hist, fir2 hist), complex64 [C, ntaps-1] each."""

    fir1: ConvFIR
    fir2: ConvFIR
    ceiling: torch.Tensor

    @classmethod
    def create(cls, block: int, fs: float,
               band: tuple[float, float] = (300.0, 3000.0),
               ntaps: int = 129, ceiling: float = 1.0, device=None):
        device = resolve_device(device)
        taps = design.bandpass_analytic(ntaps, band[0], band[1], fs)
        return cls(fir1=ConvFIR.create(taps, block, device=device),
                   fir2=ConvFIR.create(taps, block, device=device),
                   ceiling=torch.tensor(np.float32(ceiling), device=device))

    def init_state(self, channels: int):
        return (self.fir1.init_state(channels),
                self.fir2.init_state(channels))

    def __call__(self, state, z: torch.Tensor):
        h1, h2 = state
        y = _env_clip(z, self.ceiling)
        h1, y = self.fir1(h1, y)
        y = _env_clip(y, self.ceiling)
        h2, y = self.fir2(h2, y)
        y = _env_clip(y, 1.02 * self.ceiling)
        return (h1, h2), y
