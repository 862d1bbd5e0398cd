"""Fused tune + decimate front end: NCO mix and the decimating FIR in one
pass over the full-rate input, optionally with the noise blanker's gain
applied (or detected and applied) ahead of the mix.

Counterpart of ``quisk_tpu.ops.pallas_kernels.FusedTuneDecimate`` in its
three modes (the Pallas kernel ``_fused_kernel``, pallas_kernels.py:137):

- plain (``__call__``): :func:`fused_tune_decimate`;
- gained (``__call__(..., gain16=)``, pallas_kernels.py:168-174, :209-219):
  the raw window is scaled by a caller's gain on the stream's 16:1 coarse
  grid, linearly interpolated — :func:`fused_tune_decimate_gained`;
- NB-detect (``call_nb``, ``_nb_detect_in_kernel`` pallas_kernels.py:77):
  the coarse gain is computed inside the kernel from the raw window (group
  sum and max of |x|, trailing average, threshold, raised-cosine widening,
  clip, ``on`` blend) and also returned as the next block's history gain —
  :func:`fused_tune_decimate_nb`.

The CUDA kernel is ``csrc/fused_tune_decimate.cu``, one template with the
mode as its parameter; its source note says what bounds it on an H100
(fp32 FMA issue at the flagship shape, ~364 MB of bytes per block) and how
its design answers that.

Each wrapper launches the kernel for CUDA tensors and runs its ``_plain``
version (the same arithmetic in PyTorch) only for tensors on the CPU; each
has a ``_reference`` in float64 (gain computed and applied in float64, then
tune-then-filter in complex128) and its own launch counter.

The gain grid: ext = [hist | x] sample ``e`` lies in coarse group
``(e+off)//16`` at offset ``p = (e+off)%16`` with ``off = (-(T-1)) % 16``,
so x starts on a group boundary; its gain is ``g[gg]*(1-p/16) +
g[gg+1]*(p/16)``.  Groups below ``GH = (T-1+off)//16`` cover the history.
The group one past the block's end is the last group repeated in the
gained mode and computed by the widening (pulses masked to the block) in
the NB-detect mode, as the reference does in each: the two differ in the
block's last 15 samples when a pulse lies within HC groups of its end.

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
from quisk_tpu_torch.ops.noise import raised_cosine

_ERR_TAPS_TOO_LONG = -1          # the launcher's kErrTapsTooLong
_PLAN_MODES = {"plain": 0, "gained": 1, "nb": 2}   # the kernel's Mode
GROUP = 16                       # raw samples per coarse gain group
NEAR_THRESHOLD = 1e-5            # |X - thr| <= this * thr: a group that a
#                                  different summation order may flip


_PTR, _I32 = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {                  # the C launchers' argument types
    "fused_tune_decimate": [_PTR] * 6 + [_I32] * 4 + [_PTR],
    "fused_tune_decimate_gained": [_PTR] * 7 + [_I32] * 4 + [_PTR],
    "fused_tune_decimate_nb": [_PTR] * 11 + [_I32] * 6 + [_PTR],
    "fused_tune_decimate_plan": [_I32] * 6 + [_PTR],
}


def bind(lib: ctypes.CDLL, names=tuple(_SIGNATURES)) -> dict:
    """{name: launcher} of a loaded library of this kernel's source, with
    the signatures of ``names`` bound."""
    out = {}
    for name in names:
        fn = getattr(lib, name)
        fn.argtypes = _SIGNATURES[name]
        fn.restype = ctypes.c_int
        out[name] = fn
    return out


@functools.cache
def _launchers():
    """The C launchers, loaded (and built) once, their signatures bound."""
    return bind(_kernels.load("fused_tune_decimate"))


def gain_grid(ntaps: int) -> tuple[int, int]:
    """(off, GH): the shift that puts x on a group boundary, and the number
    of coarse groups covering the T-1 history samples."""
    off = (-(ntaps - 1)) % GROUP
    return off, (ntaps - 1 + off) // GROUP


def coarse_rc(kwidth: int) -> np.ndarray:
    """The raised-cosine widening taps on the coarse grid, [2*HC+1] float32
    with HC = (kwidth//2)//16 (pallas_kernels.py:435-437)."""
    return raised_cosine(2 * ((kwidth // 2) // GROUP) + 1)


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
    _kernels.check_tensors(x, {
        "x": (x, torch.complex64, (C, B)),
        "hist": (hist, torch.complex64, (C, T - 1)),
        "word": (word, torch.int64, (C,)),
        "phase0": (phase0, torch.int64, (C,)),
        "h_rev": (h_rev, torch.float32, (T,)),
    })
    if T < 1 or decim < 1 or B % decim:
        raise ValueError(f"need taps >= 1 and block {B} divisible by "
                         f"decim {decim}")


def _check_gain_block(B: int) -> None:
    if B % GROUP:
        raise ValueError(f"the gain modes need block {B} divisible by "
                         f"{GROUP}")


def _launch(name: str, x, *args) -> None:
    """Call launcher ``name`` on x's device and stream; raise on failure."""
    if x.shape[0] > 65535:
        raise ValueError(f"{x.shape[0]} channels exceed the kernel grid's "
                         f"65535")
    err = _kernels.call(x, _launchers()[name], *args)
    if err == _ERR_TAPS_TOO_LONG:
        raise ValueError("the taps at this decimation need more shared "
                         "memory than one block has")
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def launch_plan(mode: str, block: int, ntaps: int, decim: int, HC: int = 0,
                avg_win: int = 0, device="cuda") -> dict:
    """What the C launcher chooses for one call shape on a CUDA ``device``,
    without launching: outputs a block ``O``, outputs a thread ``R``,
    phases a staging group ``P``, ``threads`` a block and ``smem_bytes``.
    ``mode`` is "plain", "gained" or "nb" (``HC``, ``avg_win`` as for
    :func:`fused_tune_decimate_nb`)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    out = (ctypes.c_int * 5)()
    with torch.cuda.device(dev):
        err = _launchers()["fused_tune_decimate_plan"](
            _PLAN_MODES[mode], block, ntaps, decim, HC, avg_win, out)
    if err == _ERR_TAPS_TOO_LONG:
        raise ValueError("the taps at this decimation need more shared "
                         "memory than one block has")
    if err != 0:
        raise RuntimeError(f"fused_tune_decimate_plan failed: CUDA error "
                           f"{err}")
    return dict(zip(("O", "R", "P", "threads", "smem_bytes"), out))


# ------------------------------------------------------------ plain pieces
def _mix_fir(a, b, word, phase0, h_rev, decim: int):
    """int32-angle mix of the window a + j b [C, L], then the decimating
    FIR as an unfold plus fp32 matmul."""
    n = torch.arange(a.shape[-1], dtype=torch.int64, device=a.device)
    ph = (phase0[:, None] + word[:, None] * n[None, :]) & MASK32
    ph = ph - (ph >= (1 << 31)).to(torch.int64) * (1 << 32)   # as int32
    ang = ph.to(torch.float32) * TWO_PI_OVER_2_32
    c, s = torch.cos(ang), torch.sin(ang)
    return _banded_fir(a * c + b * s, b * c - a * s, h_rev, decim)


def _sample_gain(gext: torch.Tensor, L: int, off: int) -> torch.Tensor:
    """The coarse gain ``gext`` [C, >= (L-1+off)//16 + 2] interpolated to
    the L samples of ext."""
    e = torch.arange(L, device=gext.device) + off
    gg = e >> 4
    p = (e & 15).to(gext.dtype) / GROUP
    return gext[:, gg] * (1.0 - p) + gext[:, gg + 1] * p


def nb_coarse_gain(x, hist, on, limit, rc, avg_win: int,
                   dtype=torch.float32):
    """The NB-detect mode's gain on the coarse grid, in ``dtype``.

    Returns (gain [C, B/16 + 1] — the block's groups and the one past its
    end, X [C, B/16] group maxes, thr [C, B/16] their thresholds)."""
    C, B = x.shape
    GB = B // GROUP
    W4 = avg_win // GROUP
    need = avg_win - GROUP              # raw history the averages reach
    H = hist.shape[-1]
    tail = hist[:, max(0, H - need):]
    xs = torch.cat([tail, x], dim=-1)
    a, b = xs.real.to(dtype), xs.imag.to(dtype)
    mag = torch.sqrt(a * a + b * b)
    if H < need:                        # zeros before a short history
        mag = torch.nn.functional.pad(mag, (need - H, 0))
    mg = mag.reshape(C, W4 - 1 + GB, GROUP)
    S, X = mg.sum(-1), mg.max(-1).values[:, W4 - 1:]
    acc = S[:, W4 - 1:]
    for k in range(1, W4):
        acc = acc + S[:, W4 - 1 - k: W4 - 1 - k + GB]
    thr = limit.to(dtype) * torch.clamp(acc * (1.0 / avg_win), min=1e-12)
    pulse = (X > thr).to(dtype)
    HC = (rc.shape[0] - 1) // 2
    pz = torch.nn.functional.pad(pulse, (HC, HC + 1))
    rcd = rc.to(dtype)
    pw = torch.zeros((C, GB + 1), dtype=dtype, device=x.device)
    for t in range(2 * HC + 1):
        pw = pw + rcd[t] * pz[:, t: t + GB + 1]
    gain = torch.clamp(1.0 - pw, 0.0, 1.0)
    return 1.0 + on.to(dtype).reshape(C, 1) * (gain - 1.0), X, thr


# ------------------------------------------------------------------- plain
def fused_tune_decimate_plain(x, hist, word, phase0, h_rev, decim: int):
    """PyTorch version of the plain kernel: int32-angle mix, then the
    decimating FIR as an unfold plus fp32 matmul."""
    ext = torch.cat([hist, x], dim=-1)
    return _mix_fir(ext.real, ext.imag, word, phase0, h_rev, decim)


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
    C, B = x.shape
    y = torch.empty((C, B // decim), dtype=torch.complex64, device=x.device)
    if y.numel() == 0:
        return y
    _launch("fused_tune_decimate", x, x.data_ptr(), hist.data_ptr(),
            word.data_ptr(), phase0.data_ptr(), h_rev.data_ptr(),
            y.data_ptr(), C, B, h_rev.shape[0], decim)
    fused_tune_decimate.launches += 1
    return y


fused_tune_decimate.launches = 0


# ------------------------------------------------------------------ gained
def _scaled(x, hist, g):
    """(hist, x) scaled by the per-sample gain g [C, T-1+B]."""
    H = hist.shape[-1]
    return hist * g[:, :H], x * g[:, H:]


def fused_tune_decimate_gained_plain(x, hist, word, phase0, h_rev,
                                     decim: int, gain16):
    """PyTorch version of the gained kernel: ext scaled by the interpolated
    coarse gain (last group repeated past the end), then mix and FIR."""
    ext = torch.cat([hist, x], dim=-1)
    off, _ = gain_grid(h_rev.shape[0])
    g = _sample_gain(torch.cat([gain16, gain16[:, -1:]], dim=-1),
                     ext.shape[-1], off)
    return _mix_fir(ext.real * g, ext.imag * g, word, phase0, h_rev, decim)


def fused_tune_decimate_gained_reference(x, hist, word, phase0, h_rev,
                                         decim: int, gain16):
    """float64 reference of the gained mode (complex128)."""
    off, _ = gain_grid(h_rev.shape[0])
    g16 = gain16.to(torch.float64)
    g = _sample_gain(torch.cat([g16, g16[:, -1:]], dim=-1),
                     hist.shape[-1] + x.shape[-1], off)
    hs, xs = _scaled(x.to(torch.complex128), hist.to(torch.complex128), g)
    return fused_tune_decimate_reference(xs, hs, word, phase0, h_rev, decim)


def fused_tune_decimate_gained(x, hist, word, phase0, h_rev, decim: int,
                               gain16):
    """As :func:`fused_tune_decimate`, with ext scaled ahead of the mix by
    ``gain16`` [C, GH + B/16] float32 on the coarse grid.  Launches the
    CUDA kernel's gained mode for CUDA tensors
    (``fused_tune_decimate_gained.launches``); CPU tensors take the plain
    version."""
    _check(x, hist, word, phase0, h_rev, decim)
    C, B = x.shape
    _check_gain_block(B)
    _, GH = gain_grid(h_rev.shape[0])
    _kernels.check_tensors(x, {
        "gain16": (gain16, torch.float32, (C, GH + B // GROUP)),
    })
    if x.device.type == "cpu":
        return fused_tune_decimate_gained_plain(x, hist, word, phase0, h_rev,
                                                decim, gain16)
    y = torch.empty((C, B // decim), dtype=torch.complex64, device=x.device)
    if y.numel() == 0:
        return y
    _launch("fused_tune_decimate_gained", x, x.data_ptr(),
            hist.data_ptr(), word.data_ptr(), phase0.data_ptr(),
            h_rev.data_ptr(), y.data_ptr(), gain16.data_ptr(), C, B,
            h_rev.shape[0], decim)
    fused_tune_decimate_gained.launches += 1
    return y


fused_tune_decimate_gained.launches = 0


# --------------------------------------------------------------- NB-detect
def fused_tune_decimate_nb_plain(x, hist, word, phase0, h_rev, decim: int,
                                 hist_gain, on, limit, rc, avg_win: int):
    """PyTorch version of the NB-detect kernel -> (y, gout [C, B/16])."""
    ext = torch.cat([hist, x], dim=-1)
    gain, _, _ = nb_coarse_gain(x, hist, on, limit, rc, avg_win)
    off, _ = gain_grid(h_rev.shape[0])
    g = _sample_gain(torch.cat([hist_gain, gain], dim=-1), ext.shape[-1],
                     off)
    y = _mix_fir(ext.real * g, ext.imag * g, word, phase0, h_rev, decim)
    return y, gain[:, :-1].contiguous()


def fused_tune_decimate_nb_reference(x, hist, word, phase0, h_rev,
                                     decim: int, hist_gain, on, limit, rc,
                                     avg_win: int):
    """float64 reference of the NB-detect mode -> (y complex128, gout
    float64 [C, B/16], near bool [C, B/16]).  ``near`` marks the groups
    whose max lies within ``NEAR_THRESHOLD`` (relative) of the detection
    threshold: a float32 sum taken in another order may decide those the
    other way."""
    gain, X, thr = nb_coarse_gain(x, hist, on, limit, rc, avg_win,
                                  dtype=torch.float64)
    off, _ = gain_grid(h_rev.shape[0])
    g = _sample_gain(torch.cat([hist_gain.to(torch.float64), gain], dim=-1),
                     hist.shape[-1] + x.shape[-1], off)
    hs, xs = _scaled(x.to(torch.complex128), hist.to(torch.complex128), g)
    y = fused_tune_decimate_reference(xs, hs, word, phase0, h_rev, decim)
    near = torch.abs(X - thr) <= NEAR_THRESHOLD * thr
    return y, gain[:, :-1], near


def gains_differ(gout, gout_ref, near, HC: int) -> tuple[int, int]:
    """Hold one coarse gain to another under the near-threshold rule.

    A group's gain depends on the pulses within ``HC`` groups of it, so the
    groups within ``HC`` of a ``near`` one are set aside.  Returns (groups
    that differ among the rest, near-threshold groups)."""
    pad = torch.nn.functional.pad(near.to(torch.float32), (HC, HC))
    aside = pad.unfold(-1, 2 * HC + 1, 1).sum(-1) > 0
    differ = (gout.to(torch.float64) != gout_ref.to(torch.float64)) & ~aside
    return int(differ.sum()), int(near.sum())


def fused_tune_decimate_nb(x, hist, word, phase0, h_rev, decim: int,
                           hist_gain, on, limit, rc, avg_win: int):
    """As :func:`fused_tune_decimate`, with the noise blanker's coarse gain
    detected from the raw window and applied ahead of the mix.

    ``hist_gain`` [C, GH] float32 is the carried gain of the history
    samples, ``on`` [C, 1] float32 the stage toggle, ``limit`` a 0-dim
    float32 tensor (the threshold), ``rc`` [2*HC+1] float32 the coarse
    raised cosine (:func:`coarse_rc`), ``avg_win`` the averaging window in
    raw samples.  Returns (y, gout [C, B/16] float32).  Launches the CUDA
    kernel's NB-detect mode for CUDA tensors
    (``fused_tune_decimate_nb.launches``); CPU tensors take the plain
    version."""
    _check(x, hist, word, phase0, h_rev, decim)
    C, B = x.shape
    _check_gain_block(B)
    if avg_win < GROUP or avg_win % GROUP:
        raise ValueError(f"avg_win {avg_win} must be a multiple of {GROUP}")
    _, GH = gain_grid(h_rev.shape[0])
    if rc.dim() != 1 or rc.shape[0] % 2 == 0:
        raise ValueError(f"rc must be [2*HC+1], got {tuple(rc.shape)}")
    _kernels.check_tensors(x, {
        "hist_gain": (hist_gain, torch.float32, (C, GH)),
        "on": (on, torch.float32, (C, 1)),
        "limit": (limit, torch.float32, ()),
        "rc": (rc, torch.float32, tuple(rc.shape)),
    })
    if x.device.type == "cpu":
        return fused_tune_decimate_nb_plain(x, hist, word, phase0, h_rev,
                                            decim, hist_gain, on, limit, rc,
                                            avg_win)
    y = torch.empty((C, B // decim), dtype=torch.complex64, device=x.device)
    gout = torch.empty((C, B // GROUP), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y, gout
    _launch("fused_tune_decimate_nb", x, x.data_ptr(), hist.data_ptr(),
            word.data_ptr(), phase0.data_ptr(), h_rev.data_ptr(),
            y.data_ptr(), hist_gain.data_ptr(), on.data_ptr(),
            limit.data_ptr(), rc.data_ptr(), gout.data_ptr(),
            (rc.shape[0] - 1) // 2, avg_win, C, B, h_rev.shape[0], decim)
    fused_tune_decimate_nb.launches += 1
    return y, gout


fused_tune_decimate_nb.launches = 0


@dataclasses.dataclass(frozen=True)
class FusedTuneDecimate:
    """NCO mix + decimating FIR as one op: the chain's front end when the
    leading decimator cascade is fused (rx/chain.py).

    ``h_rev`` [T] float32 reversed taps, ``word`` [C] int64 (uint32
    values).  State (phase0 at the first history sample, raw history).
    ``create(with_gain=True)`` allows ``__call__(state, x, gain16=)``;
    ``create(nb_detect={"avg_win", "kwidth"})`` allows :meth:`call_nb`."""

    h_rev: torch.Tensor
    word: torch.Tensor
    ntaps: int
    block: int
    decim: int
    with_gain: bool = False
    avg_win: int = 0                     # NB-detect: averaging window
    kwidth: int = 0                      # NB-detect: widening kernel length
    rc: torch.Tensor | None = None       # NB-detect: coarse raised cosine

    @classmethod
    def create(cls, taps, tune_hz, sample_rate: float, block: int,
               decim: int, channels: int, with_gain: bool = False,
               nb_detect: dict | None = None, device=None):
        device = resolve_device(device)
        taps = np.asarray(taps, np.float64)
        if block % decim:
            raise ValueError(f"block {block} not divisible by decim {decim}")
        if with_gain or nb_detect is not None:
            _check_gain_block(block)
        avg_win = kwidth = 0
        rc = None
        if nb_detect is not None:
            avg_win, kwidth = int(nb_detect["avg_win"]), int(
                nb_detect["kwidth"])
            if avg_win < GROUP or avg_win % GROUP:
                raise ValueError("nb_detect needs avg_win % 16 == 0")
            rc = torch.as_tensor(coarse_rc(kwidth), device=device)
        w = freq_word(np.broadcast_to(np.atleast_1d(tune_hz), (channels,)),
                      sample_rate)
        h_rev = np.ascontiguousarray(taps[::-1]).astype(np.float32)
        return cls(h_rev=torch.as_tensor(h_rev, device=device),
                   word=phase_tensor(w, device), ntaps=taps.shape[-1],
                   block=block, decim=decim, with_gain=bool(with_gain),
                   avg_win=avg_win, kwidth=kwidth, rc=rc)

    @property
    def nb_detect(self) -> dict | None:
        """The NB-detect plan this op was created with, or None."""
        if self.rc is None:
            return None
        return {"avg_win": self.avg_win, "kwidth": self.kwidth}

    @property
    def gain_off(self) -> int:
        return gain_grid(self.ntaps)[0]

    @property
    def gain_hist_groups(self) -> int:
        """Coarse groups covering the T-1 raw history samples."""
        return gain_grid(self.ntaps)[1]

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

    def __call__(self, state, x: torch.Tensor, gain16=None):
        """One block.  ``gain16`` [C, GH + B/16] scales ext = [hist | x] on
        the coarse grid ahead of the mix (needs ``with_gain``)."""
        phase0, hist = state
        x = x.contiguous()
        if gain16 is None:
            y = fused_tune_decimate(x, hist, self.word, phase0, self.h_rev,
                                    self.decim)
        else:
            if not (self.with_gain or self.rc is not None):
                raise ValueError("create(with_gain=True) required for gain16")
            y = fused_tune_decimate_gained(x, hist, self.word, phase0,
                                           self.h_rev, self.decim,
                                           gain16.contiguous())
        return self._next_state(phase0, hist, x), y

    def call_nb(self, state, x: torch.Tensor, hist_gain, on, limit):
        """One block with the blanker's detection and gain inside the
        kernel.  ``hist_gain`` [C, GH] is the carried coarse gain of the
        history samples, ``on`` [C, 1] the stage toggle, ``limit`` the
        threshold (a 0-dim tensor).  Returns (state, y, gain [C, B/16]):
        carry ``gain[:, -GH:]``."""
        if self.rc is None:
            raise ValueError("create(nb_detect=...) required")
        phase0, hist = state
        x = x.contiguous()
        y, gout = fused_tune_decimate_nb(
            x, hist, self.word, phase0, self.h_rev, self.decim,
            hist_gain.contiguous(), on.contiguous(), limit, self.rc,
            self.avg_win)
        return self._next_state(phase0, hist, x), y, gout

    def reference(self, state, x: torch.Tensor) -> torch.Tensor:
        """float64 tune-then-filter output of one block (complex128)."""
        phase0, hist = state
        return fused_tune_decimate_reference(x, hist, self.word, phase0,
                                             self.h_rev, self.decim)
