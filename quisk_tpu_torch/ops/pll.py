"""The per-channel second-order PLL of the synchronous AM and PLL FM
demodulators: one CUDA kernel with two modes, and its plain version.

Counterpart of the per-sample scans of ``quisk_tpu.ops.nr.SyncAMDemod``
(nr.py:354-368) and ``quisk_tpu.ops.demod.PLLFMDemod`` (demod.py:160-172),
which the JAX package runs as ``unrolled_scan`` with the channels on the
vector lanes.  No Pallas kernel computes them; the kernel exists because a
per-sample loop of tensor ops costs ~25 launches a sample on a card.

- :func:`pll_sync_am` (``kSyncAM``): state (ph, fr, dc), audio
  ``vr - dc`` with the one-pole DC tracker;
- :func:`pll_fm` (``kPllFM``): state (ph, fr), audio
  ``(fr + alpha*err) * gain``, the loop's frequency estimate.

Both take ``x`` [C, B] complex64 (rows may be strided, samples
contiguous), the state as [C] float32 tensors and ``coef`` [4] float32
(alpha, beta, max_freq, dc_pole | gain), and return (state', y [C, B]
float32).  A CUDA tensor launches ``csrc/pll_demod.cu`` (each wrapper has
its own launch counter); a CPU tensor runs :func:`pll_demod_plain`, the
same step as torch ops through ``time_scan``, real and imaginary parts
split, one float32 rounding per operation as the kernel does.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from quisk_tpu_torch import _kernels
from quisk_tpu_torch.ops.scanutil import time_scan

_ERR_BAD_SHAPE = -1                   # the launcher's kErrBadShape
MODES = {"sync_am": 0, "pll_fm": 1}   # the kernel's kSyncAM / kPllFM
#: the reference wraps float32 phase against float32(pi) by float32(2 pi)
PI32 = float(np.float32(np.pi))
TWO_PI32 = float(np.float32(2 * np.pi))


#: samples a lane of the kernel holds in registers (its kTile): the edges of
#: its tiles are shapes worth checking
TILE = 16


def bind(lib: ctypes.CDLL):
    """The launcher ``pll_demod`` of a loaded build, its C types set."""
    fn = lib.pll_demod
    ptr, i64 = ctypes.c_void_p, ctypes.c_longlong
    fn.argtypes = ([ctypes.c_int, ptr, i64] + [ptr] * 8
                   + [ctypes.c_int, i64, ptr])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _launcher():
    return bind(_kernels.load("pll_demod"))


def _check(mode: str, x, state, coef) -> tuple[int, int]:
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}: want one of {sorted(MODES)}")
    if x.dim() != 2 or x.shape[1] < 1:
        raise ValueError(f"x must be [C, B] with B >= 1, got "
                         f"{tuple(x.shape)}")
    if x.dtype != torch.complex64:
        raise TypeError(f"x must be torch.complex64, got {x.dtype}")
    C, B = x.shape
    if B > 1 and x.stride(1) != 1:
        raise ValueError("x's samples must be contiguous")
    n_state = 3 if mode == "sync_am" else 2
    if len(state) != n_state:
        raise ValueError(f"{mode} state is {n_state} tensors, got "
                         f"{len(state)}")
    want = {f"state[{i}]": (s, torch.float32, (C,))
            for i, s in enumerate(state)}
    want["coef"] = (coef, torch.float32, (4,))
    _kernels.check_tensors(x, want)
    return C, B


def pll_demod_plain(mode: str, x: torch.Tensor, state: tuple,
                    coef: torch.Tensor):
    """PyTorch version of the kernel: (state', y [C, B] float32)."""
    _check(mode, x, state, coef)
    alpha, beta, max_freq, k = coef.unbind()
    lo = -max_freq
    sync_am = mode == "sync_am"
    k1 = 1.0 - k                       # 1 - dc_pole in float32

    def step(carry, xt):
        ph, fr, dc = carry
        xr, xi = xt
        co = torch.cos(ph)
        ns = -torch.sin(ph)
        vr = xr * co - xi * ns
        vi = xr * ns + xi * co
        err = torch.atan2(vi, vr)
        fr = torch.clamp(fr + beta * err, lo, max_freq)
        ae = alpha * err
        ph = ph + fr + ae
        ph = torch.where(ph > PI32, ph - TWO_PI32,
                         torch.where(ph < -PI32, ph + TWO_PI32, ph))
        if sync_am:
            dc = k * dc + k1 * vr
            return (ph, fr, dc), vr - dc
        return (ph, fr, dc), (fr + ae) * k

    dc0 = state[2] if sync_am else state[0]
    (ph, fr, dc), y = time_scan(step, (state[0], state[1], dc0),
                                (x.real, x.imag))
    return ((ph, fr, dc) if sync_am else (ph, fr)), y


def _launch(mode: str, x: torch.Tensor, state: tuple, coef: torch.Tensor):
    C, B = _check(mode, x, state, coef)
    out = tuple(torch.empty_like(s) for s in state)
    y = torch.empty((C, B), dtype=torch.float32, device=x.device)
    ph, fr = state[0], state[1]
    dc_in = state[2].data_ptr() if mode == "sync_am" else None
    dc_out = out[2].data_ptr() if mode == "sync_am" else None
    err = _kernels.call(x, _launcher(), MODES[mode], x.data_ptr(),
                        x.stride(0) if C > 1 else B, ph.data_ptr(),
                        fr.data_ptr(), dc_in, out[0].data_ptr(),
                        out[1].data_ptr(), dc_out, coef.data_ptr(),
                        y.data_ptr(), C, B)
    if err == _ERR_BAD_SHAPE:
        raise ValueError(f"pll_demod: shape {tuple(x.shape)} outside the "
                         f"kernel's limits")
    if err != 0:
        raise RuntimeError(f"pll_demod launch failed: CUDA error {err}")
    return out, y


def pll_sync_am(x: torch.Tensor, state: tuple, coef: torch.Tensor):
    """Synchronous-AM PLL over a block: state (ph, fr, dc), coef (alpha,
    beta, max_freq, dc_pole).  Launches the kernel for CUDA tensors
    (``pll_sync_am.launches``); CPU tensors take the plain version."""
    if x.device.type == "cpu":
        return pll_demod_plain("sync_am", x, state, coef)
    out = _launch("sync_am", x, state, coef)
    pll_sync_am.launches += 1
    return out


pll_sync_am.launches = 0


def pll_fm(x: torch.Tensor, state: tuple, coef: torch.Tensor):
    """FM PLL over a block: state (ph, fr), coef (alpha, beta, max_freq,
    gain); y is the loop's frequency estimate times gain.  Launches the
    kernel for CUDA tensors (``pll_fm.launches``); CPU tensors take the
    plain version."""
    if x.device.type == "cpu":
        return pll_demod_plain("pll_fm", x, state, coef)
    out = _launch("pll_fm", x, state, coef)
    pll_fm.launches += 1
    return out


pll_fm.launches = 0
