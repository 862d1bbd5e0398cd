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

:func:`tx_place` runs the transmit chain's last stage (Spot, the TX tune
NCO and the I/Q trim, ``TxChain.place``) as one launch of
``csrc/tx_place.cu``, with this NCO's phase arithmetic and rounding.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from quisk_tpu_torch import _kernels
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


_ERR_BAD_SHAPE = -1                          # the launcher's error code


def check_place(iq: torch.Tensor, spot: torch.Tensor, word: torch.Tensor,
                phase: torch.Tensor, trim: tuple) -> tuple[int, int]:
    """What :func:`tx_place` checks first: ``iq`` [C, N] complex64 (C, N
    >= 1), ``spot`` and the trim's (m00, m10, m11) [C, 1] float32, the
    tune ``word`` and ``phase`` [C] int64, all contiguous on ``iq``'s
    device.  Returns (C, N)."""
    if iq.dtype != torch.complex64:
        raise TypeError(f"iq must be torch.complex64, got {iq.dtype}")
    if iq.dim() != 2 or iq.shape[0] < 1 or iq.shape[1] < 1:
        raise ValueError(f"iq must be [C, N] with C, N >= 1, got "
                         f"{tuple(iq.shape)}")
    C, N = iq.shape
    m00, m10, m11 = trim
    _kernels.check_tensors(iq, {
        "iq": (iq, torch.complex64, (C, N)),
        "spot": (spot, torch.float32, (C, 1)),
        "word": (word, torch.int64, (C,)),
        "phase": (phase, torch.int64, (C,)),
        "m00": (m00, torch.float32, (C, 1)),
        "m10": (m10, torch.float32, (C, 1)),
        "m11": (m11, torch.float32, (C, 1))})
    return C, N


@functools.cache
def _launcher():
    fn = _kernels.load("tx_place").tx_place
    ptr, i64 = ctypes.c_void_p, ctypes.c_longlong
    fn.argtypes = [ptr] * 9 + [i64, i64, ctypes.c_float, ptr]
    fn.restype = ctypes.c_int
    return fn


def tx_place(iq: torch.Tensor, spot: torch.Tensor, word: torch.Tensor,
             phase: torch.Tensor, trim: tuple):
    """Spot, the tune NCO and the I/Q trim of ``TxChain.place_plain`` on
    ``iq``'s CUDA device in one kernel launch (``tx_place.launches``):
    (next phase [C] int64, out [C, N] complex64).  Row c is the carrier
    ``spot[c]`` where that is >= 0, else ``iq[c]``, rotated by the NCO of
    ``word[c]`` from ``phase[c]`` (:meth:`NCO.phasor`'s phase and angle,
    bit for bit), then trimmed to (m00 re, m10 re + m11 im).  Everything
    is read on the card, so nothing waits on it."""
    C, N = check_place(iq, spot, word, phase, trim)
    if iq.device.type != "cuda":
        raise ValueError(f"tx_place: no kernel for device {iq.device}")
    out = torch.empty((C, N), dtype=torch.complex64, device=iq.device)
    next_phase = torch.empty((C,), dtype=torch.int64, device=iq.device)
    err = _kernels.call(
        iq, _launcher(), iq.data_ptr(), spot.data_ptr(), word.data_ptr(),
        phase.data_ptr(), *(t.data_ptr() for t in trim), out.data_ptr(),
        next_phase.data_ptr(), C, N, TWO_PI_OVER_2_32)
    if err == _ERR_BAD_SHAPE:
        raise ValueError(f"tx_place: shape {(C, N)} outside the kernel's "
                         f"limits")
    if err != 0:
        raise RuntimeError(f"tx_place launch failed: CUDA error {err}")
    tx_place.launches += 1
    return next_phase, out


tx_place.launches = 0
