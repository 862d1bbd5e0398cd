"""EER / polar transmit split (envelope elimination and restoration,
wdsp/eer.c): the modulated TX signal becomes an envelope path (driving a
class-E/D PA's supply modulator) and a constant-amplitude phase path
(driving the PA input), with independent gains, a delay that aligns the
(slower) supply modulator, and a drive floor so the phase path never
collapses at zero envelope.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from quisk_tpu_torch._device import resolve_device


@dataclasses.dataclass(frozen=True)
class EERSplitter:
    """[C, B] complex TX -> (envelope [C, B], phase IQ [C, B]).

    With ``delay`` > 0 the state is the delay line, complex64
    [C, delay]: both paths are the input delayed by ``delay`` samples
    (eer.c ``setdelay``); with no delay the state is ``()``."""

    env_gain: torch.Tensor
    phase_gain: torch.Tensor
    floor: torch.Tensor            # least envelope for the phase drive
    delay: int = 0

    @classmethod
    def create(cls, env_gain: float = 1.0, phase_gain: float = 1.0,
               floor: float = 0.02, delay_samples: int = 0, device=None):
        device = resolve_device(device)

        def f32(v):
            return torch.tensor(np.float32(v), device=device)
        return cls(env_gain=f32(env_gain), phase_gain=f32(phase_gain),
                   floor=f32(floor), delay=int(delay_samples))

    def init_state(self, channels: int):
        if self.delay == 0:
            return ()
        return torch.zeros((channels, self.delay), dtype=torch.complex64,
                           device=self.floor.device)

    def __call__(self, state, x: torch.Tensor):
        if self.delay:
            ext = torch.cat([state, x], dim=-1)
            xd = ext[:, :x.shape[-1]]
            state = ext[:, ext.shape[-1] - self.delay:]
        else:
            xd = x
        env = torch.abs(xd)
        # constant-envelope phase drive; below the floor hold the amplitude
        # at the floor (eer.c pgain)
        scale = self.phase_gain / torch.clamp(env, min=self.floor)
        return state, (self.env_gain * env, xd * scale.to(xd.dtype))
