"""Squelches: SSB voice-activity squelch and FM noise squelch.

Counterparts of ``quisk_tpu.ops.squelch``.

- SSB squelch (quisk.c:1086 ``ssb_squelch``): 512-point FFT of the audio;
  the voice detector is a spectral-flatness distance (log of the
  arithmetic mean minus the mean of the logs of in-band power: small for
  noise, large for peaky voice); it opens the squelch for ~1 s.
- FM squelch (quisk.c:2076-2085, ``MeasureSquelch`` quisk.c:259): mean RF
  power in dB against a threshold per channel.

Both decide once per block and apply a raised-cosine gain ramp, so
opening and closing never click.  State: (hold counter [C] int32, gain
[C] float32).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from quisk_tpu_torch._device import resolve_device


def ramp_gain(prev_gain: torch.Tensor, target: torch.Tensor, block: int,
              ramp: int) -> torch.Tensor:
    """[C, block] gains moving from prev toward target over ``ramp``
    samples with a raised-cosine profile."""
    t = (torch.arange(block, dtype=torch.float32, device=prev_gain.device)
         / float(max(ramp, 1)))
    frac = 0.5 - 0.5 * torch.cos(np.pi * torch.clamp(t, max=1.0))   # 0 -> 1
    return prev_gain[:, None] + (target - prev_gain)[:, None] * frac[None, :]


def _hold_and_ramp(state, opened, hold_blocks: int, block: int, ramp: int):
    """Re-arm or count down the hold, ramp the gain toward open/closed."""
    hold, gain = state
    hold = torch.where(opened, torch.full_like(hold, hold_blocks),
                       torch.clamp(hold - 1, min=0))
    g = ramp_gain(gain, (hold > 0).to(torch.float32), block, ramp)
    return (hold, g[:, -1]), g


def _init_state(channels: int, device):
    return (torch.zeros((channels,), dtype=torch.int32, device=device),
            torch.zeros((channels,), dtype=torch.float32, device=device))


@dataclasses.dataclass(frozen=True)
class SSBSquelch:
    """Spectral-flatness voice squelch on ``[C, B]`` audio blocks."""

    threshold: torch.Tensor         # flatness distance to open (nats)
    hold_blocks: int
    block: int
    fft_size: int
    ramp: int
    f_lo_bin: int
    f_hi_bin: int

    @classmethod
    def create(cls, sample_rate: float, block: int, threshold: float = 1.2,
               hold_secs: float = 1.0, fft_size: int = 512,
               band: tuple[float, float] = (300.0, 2700.0),
               ramp_ms: float = 5.0, device=None):
        device = resolve_device(device)
        if block % fft_size:
            raise ValueError("block must be a multiple of fft_size")
        hold = max(1, int(round(hold_secs * sample_rate / block)))
        lo = int(band[0] / sample_rate * fft_size)
        hi = int(band[1] / sample_rate * fft_size)
        return cls(threshold=torch.tensor(threshold, dtype=torch.float32,
                                          device=device),
                   hold_blocks=hold, block=block, fft_size=fft_size,
                   ramp=max(1, int(ramp_ms * 1e-3 * sample_rate)),
                   f_lo_bin=max(1, lo), f_hi_bin=max(lo + 2, hi))

    def init_state(self, channels: int):
        return _init_state(channels, self.threshold.device)

    def voice_metric(self, a: torch.Tensor) -> torch.Tensor:
        """Spectral-flatness distance per channel (0 = flat/noise)."""
        segs = a.reshape(a.shape[0], self.block // self.fft_size,
                         self.fft_size)
        P = torch.abs(torch.fft.rfft(segs, dim=-1)) ** 2
        P = torch.mean(P, dim=1)[:, self.f_lo_bin: self.f_hi_bin] + 1e-20
        return (torch.log(torch.mean(P, dim=-1))
                - torch.mean(torch.log(P), dim=-1))

    def __call__(self, state, a: torch.Tensor):
        opened = self.voice_metric(a) > self.threshold
        state, g = _hold_and_ramp(state, opened, self.hold_blocks,
                                  a.shape[-1], self.ramp)
        return state, a * g


@dataclasses.dataclass(frozen=True)
class FMSquelch:
    """RF-level squelch: open when the mean carrier power exceeds the
    threshold.  Call :meth:`measure` with the pre-demod complex baseband,
    then apply to the audio."""

    threshold_db: torch.Tensor
    hold_blocks: int
    ramp: int

    @classmethod
    def create(cls, sample_rate: float, block: int,
               threshold_db: float = -60.0, hold_secs: float = 0.2,
               ramp_ms: float = 5.0, device=None):
        device = resolve_device(device)
        hold = max(1, int(round(hold_secs * sample_rate / block)))
        return cls(threshold_db=torch.tensor(threshold_db,
                                             dtype=torch.float32,
                                             device=device),
                   hold_blocks=hold,
                   ramp=max(1, int(ramp_ms * 1e-3 * sample_rate)))

    def init_state(self, channels: int):
        return _init_state(channels, self.threshold_db.device)

    def measure(self, rf: torch.Tensor) -> torch.Tensor:
        """Mean RF power in dB per channel from the complex baseband."""
        p = torch.mean(torch.abs(rf) ** 2, dim=-1)
        return 10.0 * torch.log10(p + 1e-20)

    def __call__(self, state, audio: torch.Tensor, rf_db: torch.Tensor):
        state, g = _hold_and_ramp(state, rf_db > self.threshold_db,
                                  self.hold_blocks, audio.shape[-1],
                                  self.ramp)
        return state, audio * g
