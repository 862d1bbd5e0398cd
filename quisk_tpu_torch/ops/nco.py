"""Numerically-controlled oscillator / complex mixer.

Phase is an exact 32-bit integer accumulator (``2**32`` counts per turn,
per-channel frequency words, exact modular wrap), so it is drift-free
across any number of blocks (quisk.c:2482-2488 renormalises a rotating
phasor instead).  PyTorch has no full uint32 arithmetic on CUDA, so words
and phases ride as int64 tensors holding values in [0, 2**32), masked to
32 bits after every add and multiply.

This unfused mixer converts the UNSIGNED phase to float32, as
``quisk_tpu.ops.nco.NCO`` does; the fused front kernel converts the
phase reinterpreted as int32 (ops/fused_front.py).  Both are right mod
2 pi but round differently; each matches its own counterpart.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from quisk_tpu_torch._device import resolve_device

TWO_PI_OVER_2_32 = float(np.float32(2.0 * np.pi / 4294967296.0))
MASK32 = 0xFFFFFFFF


def freq_word(freq_hz, sample_rate: float) -> np.ndarray:
    """Per-channel uint32 phase increment for freq_hz at sample_rate."""
    f = np.atleast_1d(np.asarray(freq_hz, dtype=np.float64))
    w = np.round((f / sample_rate) * 4294967296.0).astype(np.int64)
    return w.astype(np.uint32)


def phase_tensor(values, device) -> torch.Tensor:
    """uint32 numpy values -> int64 tensor in [0, 2**32)."""
    return torch.as_tensor(np.asarray(values).astype(np.uint32)
                           .astype(np.int64), device=device)


@dataclasses.dataclass(frozen=True)
class NCO:
    """Batch of per-channel oscillators: ``word`` [C] int64 (uint32
    values); state is the [C] phase at the start of the next block."""

    word: torch.Tensor
    block: int

    @classmethod
    def create(cls, freq_hz, sample_rate: float, block: int, channels: int,
               device=None):
        device = resolve_device(device)
        w = freq_word(freq_hz, sample_rate)
        if w.shape[0] == 1:
            w = np.broadcast_to(w, (channels,))
        if w.shape != (channels,):
            raise ValueError(f"want {channels} frequencies, got {w.shape}")
        return cls(word=phase_tensor(w, device), block=block)

    def init_state(self, channels: int) -> torch.Tensor:
        return torch.zeros((channels,), dtype=torch.int64,
                           device=self.word.device)

    def phasor(self, phase: torch.Tensor):
        """(next_phase [C], e^{j theta} [C, block] complex64)."""
        n = torch.arange(self.block, dtype=torch.int64, device=phase.device)
        ph = (phase[:, None] + self.word[:, None] * n[None, :]) & MASK32
        ang = ph.to(torch.float32) * TWO_PI_OVER_2_32
        z = torch.complex(torch.cos(ang), torch.sin(ang))
        next_phase = (phase + self.word * self.block) & MASK32
        return next_phase, z

    def __call__(self, phase: torch.Tensor, x: torch.Tensor):
        """Mix x [C, block] down by the NCO frequency: y = x * e^{-j theta}."""
        next_phase, z = self.phasor(phase)
        return next_phase, x * torch.conj(z)
