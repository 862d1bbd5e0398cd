"""The per-sample state machines of the AGC and the ALC: one CUDA kernel with
three modes, and their plain versions.

Counterpart of the per-sample scans of ``quisk_tpu.ops.agc``: ``TxALC``
(agc.py:408-452), ``WcpAGC`` (:254-323) and ``HangAGC`` (:154-171), which
the JAX package runs as ``unrolled_scan`` under ``jit`` with the channels
on the vector lanes.  No Pallas kernel computes them; the kernel exists
because a per-sample loop of tensor ops costs 25-75 launches a sample on a
card.  What depends on the input alone (the delay line, the window max,
the gain limit, |x|, the per-mode gain memory, the final product with the
delayed samples) stays as torch ops in ``ops/agc.py``, once a block.

- :func:`tx_alc_scan` (``kTxAlc``): ``magn`` [C, B] float32, the state
  (g, gain_change, final_gain, next_change, counter, fault: float32 [C];
  block_index: int32 [C]; index: int32 0-dim), ``coef`` [5] float32
  (target, gain_min, gain_max, d_limit, min_magn) and the delay ``buf``;
  returns (state', gain [C, B] float32, clip [C, B] bool), the gain each
  sample sees and the per-sample clip decision;
- :func:`wcp_scan` (``kWcp``): the window max ``rm`` and the delayed
  envelope ``ao`` [C, B] float32, the state (volts, save_volts, fast_ba,
  hang_ba: float32 [C]; hang_counter, state, decay_type: int32 [C]),
  ``coef`` [12] float32 in :data:`WCP_COEF` order; returns (state', mult
  [C, B] float32);
- :func:`hang_scan` (``kHang``): the log-gain limit ``lim`` [C, B]
  float32, the state (log-gain float32 [C], hang counter int32 [C]),
  ``coef`` [1] float32 (release_inc); returns (state', log-gain [C, B]).

Inputs may have strided rows; their samples must be contiguous.  A CUDA
tensor launches ``csrc/agc_scan.cu`` (each wrapper has its own launch
counter); a CPU tensor runs the plain version, the same step as torch ops
through ``time_scan``; any other device raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from quisk_tpu_torch import _kernels
from quisk_tpu_torch.ops.scanutil import time_scan

_ERR_BAD_SHAPE = -1                      # the launcher's kErrBadShape
MODES = {"tx_alc": 0, "wcp": 1, "hang": 2}   # kTxAlc / kWcp / kHang
#: WcpAGC's constants, in the order of its ``coef``
WCP_COEF = ("attack_mult", "decay_mult", "fast_decay_mult", "fast_backmult",
            "hang_backmult", "hang_decay_mult", "out_target", "min_volts",
            "slope_constant", "hang_level", "pop_ratio", "inv_max_input")
# per mode: inputs, float32 [C] states, int32 [C] states, coef length
_LAYOUT = {"tx_alc": (1, 6, 1, 5), "wcp": (2, 4, 3, len(WCP_COEF)),
           "hang": (1, 1, 1, 1)}
_MAX_STATE = 8                           # the launcher's kMaxState
#: samples a lane of the kernel holds in registers (its kTile): the edges of
#: its tiles are shapes worth checking
TILE = 16


def bind(lib: ctypes.CDLL):
    """The launcher ``agc_scan`` of a loaded build, its C types set."""
    fn = lib.agc_scan
    ptr, i64, arr = ctypes.c_void_p, ctypes.c_longlong, ctypes.POINTER(
        ctypes.c_void_p)
    fn.argtypes = [ctypes.c_int, ptr, i64, ptr, i64, arr, arr, ptr, ptr,
                   ptr, ctypes.c_int, i64, ctypes.c_int, ctypes.c_int, ptr]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _launcher():
    return bind(_kernels.load("agc_scan"))


def check(mode: str, xs: tuple, state: tuple, coef: torch.Tensor
          ) -> tuple[int, int]:
    """What every wrapper and plain version checks first: the mode, the
    inputs [C, B] float32 with contiguous samples, the state tensors
    (contiguous, float32 then int32, [C]; ``tx_alc``'s last one the 0-dim
    int32 index) and ``coef``.  Returns (C, B)."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}: want one of {sorted(MODES)}")
    n_in, n_f, n_i, n_coef = _LAYOUT[mode]
    if len(xs) != n_in:
        raise ValueError(f"{mode} takes {n_in} inputs, got {len(xs)}")
    x = xs[0]
    if x.dim() != 2 or x.shape[1] < 1:
        raise ValueError(f"inputs must be [C, B] with B >= 1, got "
                         f"{tuple(x.shape)}")
    C, B = x.shape
    for i, t in enumerate(xs):
        if t.dtype != torch.float32:
            raise TypeError(f"input {i} must be torch.float32, got "
                            f"{t.dtype}")
        if tuple(t.shape) != (C, B) or t.device != x.device:
            raise ValueError(f"input {i} must be {(C, B)} on {x.device}")
        if (B > 1 and t.stride(1) != 1) or (C > 1 and t.stride(0) < B):
            raise ValueError(f"input {i}: samples must be contiguous and "
                             f"rows must not overlap")
    n_state = n_f + n_i + (mode == "tx_alc")
    if len(state) != n_state:
        raise ValueError(f"{mode} state is {n_state} tensors, got "
                         f"{len(state)}")
    want = {f"state[{i}]": (s, torch.float32 if i < n_f else torch.int32,
                            (C,)) for i, s in enumerate(state)}
    if mode == "tx_alc":
        want[f"state[{n_state - 1}]"] = (state[-1], torch.int32, ())
    want["coef"] = (coef, torch.float32, (n_coef,))
    _kernels.check_tensors(x, want)
    return C, B


def tx_alc_plain(magn: torch.Tensor, state: tuple, coef: torch.Tensor,
                 buf: int):
    """PyTorch version of ``kTxAlc`` (the step of microphone.c:270-358
    ``process_alc``, as quisk_tpu/ops/agc.py:408-452): (state', gain,
    clip)."""
    check("tx_alc", (magn,), state, coef)
    A = buf
    tgt, lo, hi, d_limit, min_magn = coef.unbind()
    # A float32 tensor, not the Python int: on a CUDA tensor torch turns
    # a division by a Python number into a product with its reciprocal,
    # which rounds otherwise than the CPU's division and the kernel's
    A_f = torch.full((), float(A), dtype=torch.float32, device=magn.device)
    # the terms that depend on the input alone, for the whole block
    t_over_m = tgt / torch.clamp(magn, min=1e-9)
    silent = magn < min_magn
    loud_f = (~silent).to(torch.float32)
    silent_f = silent.to(torch.float32)
    B = magn.shape[-1]
    idx = torch.remainder(state[7].to(torch.int64)
                          + torch.arange(B, device=magn.device),
                          A).to(torch.int32)
    where = torch.where

    def step(carry, xs):
        g, gc, fg, nc, cnt, flt, bi = carry
        mg, tm, sil, ld, sf, ix = xs
        clip = mg * (g + gc * A) > tgt
        # clip: down-ramp to land exactly at the safe gain
        fg1 = torch.clamp(g + (tm - g) / A_f * A_f, lo, hi)
        gc1 = (fg1 - g) / A_f
        # block complete: recovery ramp from the observed headroom,
        # bounded by the gain-doubling time
        blk = bi == ix
        gc2 = where(flt < A - 10, torch.clamp(nc, max=d_limit), gc)
        fg2 = torch.clamp(g + gc2 * A, lo, hi)
        gc2 = (fg2 - g) / A_f
        # observe
        cnt3 = cnt + ld
        d3 = (tm - fg) / torch.clamp(cnt3, min=1.0)
        nc3 = where(sil, nc, torch.minimum(nc, d3))
        rst = clip | blk
        gc_n = where(clip, gc1, where(blk, gc2, gc))
        fg_n = where(clip, fg1, where(blk, fg2, fg))
        carry = (g + gc_n, gc_n, fg_n, where(rst, 1e10, nc3),
                 where(rst, 0.0, cnt3), where(rst, 0.0, flt + sf),
                 where(clip, ix, bi))
        return carry, (g, clip)

    carry, (gains, clips) = time_scan(
        step, tuple(state[:7]),
        (magn, t_over_m, silent, loud_f, silent_f, idx))
    index = ((idx[-1] + 1) % A).to(torch.int32)
    return carry + (index,), gains, clips


def wcp_plain(rm: torch.Tensor, ao: torch.Tensor, state: tuple,
              coef: torch.Tensor, hang_samples: int, hang_enable: bool):
    """PyTorch version of ``kWcp`` (the state machine of wdsp/wcpAGC.c:
    161-342 ``xwcpagc``, as quisk_tpu/ops/agc.py:254-313): (state',
    mult)."""
    check("wcp", (rm, ao), state, coef)
    k = dict(zip(WCP_COEF, coef.unbind()))
    where = torch.where

    def const(v):
        return torch.full_like(state[5], v)
    c0, c1, c2, c3, c4 = (const(v) for v in range(5))
    hang_full = const(hang_samples)

    def step(carry, xs):
        volts, save, fba, hba, hc, s, dt = carry
        rm, ao = xs
        fba = k["fast_backmult"] * ao + (1 - k["fast_backmult"]) * fba
        hba = k["hang_backmult"] * ao + (1 - k["hang_backmult"]) * hba
        hc = torch.clamp(hc - 1, min=0)

        dv = rm - volts
        att = volts + dv * k["attack_mult"]
        dec = volts + dv * k["decay_mult"]
        fdec = volts + dv * k["fast_decay_mult"]
        hdec = volts + dv * k["hang_decay_mult"]
        attack = rm >= volts
        if hang_enable:
            hang_ok = hba > k["hang_level"]
        else:
            hang_ok = torch.zeros_like(attack)

        # state 0: attack / pop fast-decay / hang entry / decay
        pop = volts > k["pop_ratio"] * fba
        v0 = where(attack, att, where(pop, fdec,
                                      where(hang_ok, volts, dec)))
        s0 = where(attack, c0, where(pop, c1, where(hang_ok, c2, c3)))
        enter_hang = ~attack & ~pop & hang_ok
        hc0 = where(enter_hang, hang_full, hc)
        dt0 = where(attack | pop, dt, where(hang_ok, c1, c0))
        # state 1: fast decay toward save_volts
        above = volts > save
        v1 = where(attack, att, where(above, fdec, where(
            hc > 0, volts, where(dt == 0, dec, hdec))))
        s1 = where(attack, c0, where(above, c1, where(
            hc > 0, c2, where(dt == 0, c3, c4))))
        # state 2: hang hold
        v2 = where(attack, att, where(hc == 0, hdec, volts))
        s2 = where(attack, c0, where(hc == 0, c4, c2))
        # states 3 / 4: plain decay / post-hang decay
        v3 = where(attack, att, dec)
        s3 = where(attack, c0, c3)
        v4 = where(attack, att, hdec)
        s4 = where(attack, c0, c4)

        # re-entering attack from 2/3/4 snapshots save_volts
        save = where((s >= 2) & attack, volts, save)
        volts_n = where(s == 0, v0, where(s == 1, v1, where(
            s == 2, v2, where(s == 3, v3, v4))))
        s_n = where(s == 0, s0, where(s == 1, s1, where(
            s == 2, s2, where(s == 3, s3, s4))))
        hc = where(s == 0, hc0, hc)
        dt = where(s == 0, dt0, dt)

        volts_n = torch.maximum(volts_n, k["min_volts"])
        mult = (k["out_target"] - k["slope_constant"] * torch.clamp(
            torch.log10(k["inv_max_input"] * volts_n), max=0.0)) / volts_n
        return (volts_n, save, fba, hba, hc, s_n, dt), mult

    return time_scan(step, tuple(state), (rm, ao))


def hang_plain(lim: torch.Tensor, state: tuple, coef: torch.Tensor,
               hang_samples: int):
    """PyTorch version of ``kHang`` (quisk_tpu/ops/agc.py:154-171):
    (state', log-gain after each sample)."""
    check("hang", (lim,), state, coef)
    inc = coef[0]
    hang_full = torch.full_like(state[1], hang_samples)

    def step(carry, lim):
        lg, hang = carry
        attack = lim < lg                      # must reduce gain now
        lg = torch.where(attack, lim, torch.where(
            hang > 0, lg, torch.minimum(lg + inc, lim)))
        hang = torch.where(attack, hang_full, torch.clamp(hang - 1, min=0))
        return (lg, hang), lg

    return time_scan(step, tuple(state), lim)


def _launch(mode: str, xs: tuple, state: tuple, coef: torch.Tensor,
            n: int, flag: int, want_clip: bool = False):
    """The kernel on ``xs``' CUDA device: (state', y, clip or None)."""
    x = xs[0]
    if x.device.type != "cuda":
        raise ValueError(f"agc_scan: no kernel for device {x.device}")
    C, B = check(mode, xs, state, coef)
    out = tuple(torch.empty_like(s) for s in state)
    y = torch.empty((C, B), dtype=torch.float32, device=x.device)
    clip = (torch.empty((C, B), dtype=torch.bool, device=x.device)
            if want_clip else None)
    x1 = xs[1] if len(xs) > 1 else x
    ld = [t.stride(0) if C > 1 else B for t in (x, x1)]
    st_in = (ctypes.c_void_p * _MAX_STATE)(*(s.data_ptr() for s in state))
    st_out = (ctypes.c_void_p * _MAX_STATE)(*(s.data_ptr() for s in out))
    err = _kernels.call(x, _launcher(), MODES[mode], x.data_ptr(), ld[0],
                        x1.data_ptr(), ld[1], st_in, st_out,
                        coef.data_ptr(), y.data_ptr(),
                        clip.data_ptr() if want_clip else None, C, B, n,
                        flag)
    if err == _ERR_BAD_SHAPE:
        raise ValueError(f"agc_scan: shape {(C, B)} or parameter {n} "
                         f"outside the kernel's limits")
    if err != 0:
        raise RuntimeError(f"agc_scan launch failed: CUDA error {err}")
    return out, y, clip


def tx_alc_scan(magn: torch.Tensor, state: tuple, coef: torch.Tensor,
                buf: int, clips: bool = True):
    """TxALC's per-sample recurrence over a block: (state', gain, clip;
    clip None if not ``clips``).  Launches the kernel for CUDA tensors
    (``tx_alc_scan.launches``); CPU tensors take the plain version."""
    if magn.device.type == "cpu":
        st, g, c = tx_alc_plain(magn, state, coef, buf)
        return st, g, (c if clips else None)
    out = _launch("tx_alc", (magn,), state, coef, buf, 0, clips)
    tx_alc_scan.launches += 1
    return out


tx_alc_scan.launches = 0


def wcp_scan(rm: torch.Tensor, ao: torch.Tensor, state: tuple,
             coef: torch.Tensor, hang_samples: int, hang_enable: bool):
    """WcpAGC's state machine over a block: (state', mult).  Launches the
    kernel for CUDA tensors (``wcp_scan.launches``); CPU tensors take the
    plain version."""
    if rm.device.type == "cpu":
        return wcp_plain(rm, ao, state, coef, hang_samples, hang_enable)
    st, y, _ = _launch("wcp", (rm, ao), state, coef, hang_samples,
                       int(bool(hang_enable)))
    wcp_scan.launches += 1
    return st, y


wcp_scan.launches = 0


def hang_scan(lim: torch.Tensor, state: tuple, coef: torch.Tensor,
              hang_samples: int):
    """HangAGC's recurrence over a block: (state', log-gain [C, B]).
    Launches the kernel for CUDA tensors (``hang_scan.launches``); CPU
    tensors take the plain version."""
    if lim.device.type == "cpu":
        return hang_plain(lim, state, coef, hang_samples)
    st, y, _ = _launch("hang", (lim,), state, coef, hang_samples, 0)
    hang_scan.launches += 1
    return st, y


hang_scan.launches = 0
