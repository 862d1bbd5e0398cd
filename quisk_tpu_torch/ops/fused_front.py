"""Fused tune + decimate front end: NCO mix and the decimating FIR in one
pass over the full-rate input.

Counterpart of ``quisk_tpu.ops.pallas_kernels.FusedTuneDecimate`` in its
plain mode (the Pallas kernel ``_fused_kernel``, pallas_kernels.py:137).
The CUDA kernel is ``csrc/fused_tune_decimate.cu``; its source note says
what bounds it on an H100 (fp32 FMA issue at the flagship shape, ~364 MB
of bytes per block) and how its design answers that: the direct polyphase
dot instead of the TPU's banded matrix, the tile's window mixed once into
shared memory in polyphase order, history and block read from their own
buffers.

:func:`fused_tune_decimate` launches the kernel for CUDA tensors and runs
:func:`fused_tune_decimate_plain` (the same arithmetic in PyTorch) only
for tensors on the CPU.  :func:`fused_tune_decimate_reference` is the
float64 reference (``FusedTuneDecimate.reference`` semantics).

State: (phase0 [C] int64 holding uint32 values — the phase at the first
history sample, raw history [C, T-1] complex64).  The mix converts the
phase reinterpreted as int32 to float, as the TPU kernel does
(pallas_kernels.py:201-204); the unfused NCO converts it unsigned.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from quisk_tpu_torch import _kernels
from quisk_tpu_torch._device import resolve_device
from quisk_tpu_torch.ops.fir import banded_taps
from quisk_tpu_torch.ops.nco import (MASK32, TWO_PI_OVER_2_32, freq_word,
                                     phase_tensor)

_ERR_TAPS_TOO_LONG = -1          # the launcher's kErrTapsTooLong


@functools.cache
def _launcher():
    """The C launcher, loaded (and built) once, its signature bound."""
    fn = _kernels.load("fused_tune_decimate").fused_tune_decimate
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _banded_fir(re: torch.Tensor, im: torch.Tensor, h_rev: torch.Tensor,
                d: int) -> torch.Tensor:
    """y[c, k] = sum_t (re + j im)[c, k*d + t] h_rev[t] as patches of
    K = R*d + T - 1 samples times the banded [K, R] tap matrix."""
    C, L = re.shape
    T = h_rev.shape[0]
    N = (L - (T - 1)) // d
    R = 128
    while N % R:
        R //= 2
    M = banded_taps(h_rev, R, d)
    patches = torch.stack([re, im], dim=1).unfold(-1, M.shape[0], R * d)
    y = torch.matmul(patches, M).reshape(C, 2, N)
    return torch.complex(y[:, 0], y[:, 1])


def _check(x, hist, word, phase0, h_rev, decim):
    if x.dim() != 2:
        raise ValueError(f"x must be [C, B], got {tuple(x.shape)}")
    C, B = x.shape
    T = h_rev.shape[0] if h_rev.dim() == 1 else -1
    want = {"x": (x, torch.complex64, (C, B)),
            "hist": (hist, torch.complex64, (C, T - 1)),
            "word": (word, torch.int64, (C,)),
            "phase0": (phase0, torch.int64, (C,)),
            "h_rev": (h_rev, torch.float32, (T,))}
    for name, (t, dt, shape) in want.items():
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if T < 1 or decim < 1 or B % decim:
        raise ValueError(f"need taps >= 1 and block {B} divisible by "
                         f"decim {decim}")


def fused_tune_decimate_plain(x, hist, word, phase0, h_rev, decim: int):
    """PyTorch version of the kernel: int32-angle mix, then the decimating
    FIR as an unfold plus fp32 matmul."""
    ext = torch.cat([hist, x], dim=-1)
    n = torch.arange(ext.shape[-1], dtype=torch.int64, device=x.device)
    ph = (phase0[:, None] + word[:, None] * n[None, :]) & MASK32
    ph = ph - (ph >= (1 << 31)).to(torch.int64) * (1 << 32)   # as int32
    ang = ph.to(torch.float32) * TWO_PI_OVER_2_32
    c, s = torch.cos(ang), torch.sin(ang)
    a, b = ext.real, ext.imag
    return _banded_fir(a * c + b * s, b * c - a * s, h_rev, decim)


def fused_tune_decimate_reference(x, hist, word, phase0, h_rev, decim: int,
                                  chunk: int = 256):
    """float64 reference: exact phase, tune then filter (complex128)."""
    C = x.shape[0]
    h = h_rev.to(torch.float64)
    out = []
    for c0 in range(0, C, chunk):
        sl = slice(c0, c0 + chunk)
        ext = torch.cat([hist[sl], x[sl]], dim=-1).to(torch.complex128)
        n = torch.arange(ext.shape[-1], dtype=torch.int64, device=x.device)
        ph = (phase0[sl, None] + word[sl, None] * n[None, :]) & MASK32
        ang = ph.to(torch.float64) * (2.0 * np.pi / 2 ** 32)
        tuned = ext * torch.exp(-1j * ang)
        out.append(_banded_fir(tuned.real, tuned.imag, h, decim))
    return torch.cat(out, dim=0)


def fused_tune_decimate(x, hist, word, phase0, h_rev, decim: int):
    """y [C, B/decim] complex64 = decimating FIR of ext = [hist | x] mixed
    by the int32-angle NCO.  Launches the CUDA kernel for CUDA tensors
    (``fused_tune_decimate.launches`` counts the launches); tensors on the
    CPU take the plain version."""
    _check(x, hist, word, phase0, h_rev, decim)
    if x.device.type == "cpu":
        return fused_tune_decimate_plain(x, hist, word, phase0, h_rev, decim)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    C, B = x.shape
    T = h_rev.shape[0]
    N = B // decim
    y = torch.empty((C, N), dtype=torch.complex64, device=x.device)
    if C == 0 or N == 0:
        return y
    if C > 65535:
        raise ValueError(f"{C} channels exceed the kernel grid's 65535")
    with torch.cuda.device(x.device):
        err = _launcher()(x.data_ptr(), hist.data_ptr(), word.data_ptr(),
                          phase0.data_ptr(), h_rev.data_ptr(), y.data_ptr(),
                          C, B, T, decim,
                          torch.cuda.current_stream(x.device).cuda_stream)
    if err == _ERR_TAPS_TOO_LONG:
        raise ValueError(f"taps {T} at decim {decim} need more shared "
                         f"memory than one block has")
    if err != 0:
        raise RuntimeError(f"fused_tune_decimate launch failed: CUDA error "
                           f"{err}")
    fused_tune_decimate.launches += 1
    return y


fused_tune_decimate.launches = 0


@dataclasses.dataclass(frozen=True)
class FusedTuneDecimate:
    """NCO mix + decimating FIR as one op: the chain's front end when the
    leading decimator cascade is fused (rx/chain.py).

    ``h_rev`` [T] float32 reversed taps, ``word`` [C] int64 (uint32
    values).  State (phase0 at the first history sample, raw history)."""

    h_rev: torch.Tensor
    word: torch.Tensor
    ntaps: int
    block: int
    decim: int

    @classmethod
    def create(cls, taps, tune_hz, sample_rate: float, block: int,
               decim: int, channels: int, device=None):
        device = resolve_device(device)
        taps = np.asarray(taps, np.float64)
        if block % decim:
            raise ValueError(f"block {block} not divisible by decim {decim}")
        w = freq_word(np.broadcast_to(np.atleast_1d(tune_hz), (channels,)),
                      sample_rate)
        h_rev = np.ascontiguousarray(taps[::-1]).astype(np.float32)
        return cls(h_rev=torch.as_tensor(h_rev, device=device),
                   word=phase_tensor(w, device), ntaps=taps.shape[-1],
                   block=block, decim=decim)

    def with_word(self, word) -> "FusedTuneDecimate":
        """Same filter, new uint32 frequency words (a retune)."""
        return dataclasses.replace(self,
                                   word=phase_tensor(word, self.word.device))

    def init_state(self, channels: int):
        # a fresh stream has phase 0 at its first real sample, T-1 samples
        # after the first history sample: start at -(T-1)*word mod 2^32
        ph0 = (-(self.word * (self.ntaps - 1))) & MASK32
        return (ph0, torch.zeros((channels, self.ntaps - 1),
                                 dtype=torch.complex64,
                                 device=self.word.device))

    def _next_state(self, phase0, hist, x):
        T1 = self.ntaps - 1
        if x.shape[-1] >= T1:
            new_hist = x[:, x.shape[-1] - T1:].contiguous()
        else:
            new_hist = torch.cat([hist, x], dim=-1)[:, x.shape[-1]:]
        return ((phase0 + self.word * self.block) & MASK32, new_hist)

    def __call__(self, state, x: torch.Tensor):
        phase0, hist = state
        x = x.contiguous()
        y = fused_tune_decimate(x, hist, self.word, phase0, self.h_rev,
                                self.decim)
        return self._next_state(phase0, hist, x), y

    def reference(self, state, x: torch.Tensor) -> torch.Tensor:
        """float64 tune-then-filter output of one block (complex128)."""
        phase0, hist = state
        return fused_tune_decimate_reference(x, hist, self.word, phase0,
                                             self.h_rev, self.decim)
