"""Delay-line (lookahead) AGC, and the WDSP AGC with its hang machine.

Parity: the reference AGC (quisk.c:2162 ``process_agc``) keeps a ~15 ms
lookahead buffer, tracks the max magnitude in it, drops gain at once on
clip and releases exponentially.  In the log domain the per-sample
recurrence is ``lg[n] = min(lg[n-1] + d, l[n])``, a composition of the
associative maps ``x -> min(x + d, l)``.  :class:`AGC` runs a block in
one launch of ``csrc/agc_delay.cu`` on a card (:func:`agc_delay`: the
delay line, the window max, the limit, the scan and the gain, one thread
block a channel); on the CPU its plain version, :meth:`AGC.plain`, runs
them as torch ops: the lookahead envelope a sliding maximum by the van
Herk two-pass cummax, the scan evaluated over the block in log-depth
(Hillis-Steele doubling).

:class:`HangAGC` and :class:`WcpAGC` (wdsp/wcpAGC.c) carry a state machine
that decides per sample, and so does the TX path's :class:`TxALC`
(microphone.c:270-358).  Each runs its recurrence through ops/agc_scan.py:
one kernel launch a block on a card (``csrc/agc_scan.cu``, one thread a
channel), the plain per-sample loop on the CPU; what depends on the input
alone stays here as torch ops, once a block.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from quisk_tpu_torch import _kernels
from quisk_tpu_torch._device import resolve_device
from quisk_tpu_torch.ops.agc_scan import (WCP_COEF, hang_scan,
                                          tx_alc_scan, wcp_scan)
from quisk_tpu_torch.oracle.wcpagc import WcpParams


def sliding_max(x: torch.Tensor, window: int) -> torch.Tensor:
    """max over x[..., n : n+window] for each n (right-looking), van Herk.

    x: [C, B].  Windows that run past the end use what exists.
    """
    C, B = x.shape
    W = window
    nblk = -(-B // W)
    pad = nblk * W - B
    neg = torch.finfo(x.dtype).min
    xp = torch.nn.functional.pad(x, (0, pad), value=neg)
    blocks = xp.reshape(C, nblk, W)
    pref = torch.cummax(blocks, dim=2).values.reshape(C, nblk * W)
    suff = torch.cummax(blocks.flip(2), dim=2).values.flip(2)
    suff = suff.reshape(C, nblk * W)
    # out[n] = max(suffix max of n's block, prefix max at n + W - 1)
    pref_ext = torch.nn.functional.pad(pref, (0, W), value=neg)
    return torch.maximum(suff[:, :B], pref_ext[:, W - 1:W - 1 + B])


def min_scan(limit: torch.Tensor, inc, lg0: torch.Tensor) -> torch.Tensor:
    """lg[n] = min(lg[n-1] + inc, limit[n]) for all n.

    The maps (i, m): x -> min(x + i, m) compose as
    (i1, m1) then (i2, m2) = (i1 + i2, min(m1 + i2, m2)); a log-step
    doubling scan over the block axis evaluates all prefixes.
    """
    I = torch.broadcast_to(torch.as_tensor(inc, dtype=limit.dtype,
                                           device=limit.device), limit.shape)
    M = limit
    n = limit.shape[-1]
    s = 1
    while s < n:
        M = torch.cat([M[..., :s],
                       torch.minimum(M[..., :-s] + I[..., s:], M[..., s:])],
                      dim=-1)
        I = torch.cat([I[..., :s], I[..., :-s] + I[..., s:]], dim=-1)
        s *= 2
    return torch.minimum(lg0[:, None] + I, M)


@dataclasses.dataclass(frozen=True)
class AGC:
    """Lookahead AGC on real audio ``[C, B]`` blocks.

    target: output peak level; max_lgain: log of the gain ceiling;
    release_inc: log-gain increase per sample; lookahead: delay-buffer
    length in samples (15 ms at 48 k = 720 in the reference).
    """

    target: torch.Tensor
    max_lgain: torch.Tensor
    release_inc: torch.Tensor
    lookahead: int

    @classmethod
    def create(cls, sample_rate: float, target: float = 0.9,
               max_gain_db: float = 80.0, release_db_per_s: float = 60.0,
               lookahead_ms: float = 15.0, device=None):
        device = resolve_device(device)
        W = max(1, int(round(lookahead_ms * 1e-3 * sample_rate)))
        inc = np.log(10.0) * release_db_per_s / 20.0 / sample_rate

        def f32(v):
            return torch.tensor(np.float32(v), device=device)
        return cls(target=f32(target),
                   max_lgain=f32(np.log(10.0) * max_gain_db / 20.0),
                   release_inc=f32(inc), lookahead=W)

    def init_state(self, channels: int):
        dev = self.target.device
        delay = torch.zeros((channels, self.lookahead), dtype=torch.float32,
                            device=dev)
        lg = torch.zeros((channels,), dtype=torch.float32, device=dev)
        return delay, lg

    def __call__(self, state, a: torch.Tensor):
        """a [C, B] float32 audio -> gain-controlled audio, same shape;
        output sample n is input sample n - lookahead.  A CUDA tensor
        launches the kernel (:func:`agc_delay`), a CPU tensor runs
        :meth:`plain`; any other device raises."""
        if a.device.type == "cpu":
            check(self, state, a)
            return self.plain(state, a)
        return agc_delay(self, state, a)

    def plain(self, state, a: torch.Tensor):
        """The block as torch ops on any device: the delay line joined,
        the window max, the limit and the doubling scan."""
        delay, lg_prev = state
        W = self.lookahead
        B = a.shape[-1]
        ext = torch.cat([delay, a], dim=-1)               # [C, W+B]
        limit = _gain_limit(torch.abs(ext), W, B, self.target,
                            self.max_lgain)
        lg = min_scan(limit, self.release_inc, lg_prev)
        out = ext[:, :B] * torch.exp(lg)
        return (ext[:, ext.shape[-1] - W:], lg[:, -1]), out


_ERR_BAD_SHAPE, _ERR_SHARED_MEMORY = -1, -2   # the launcher's error codes


def check(op: AGC, state, a: torch.Tensor) -> tuple[int, int]:
    """What both routes of :class:`AGC` check first: ``a`` [C, B] float32
    with contiguous samples and rows that do not overlap, the state's
    delay [C, lookahead] (the same) and log gain [C], float32, and the
    0-dim float32 parameters, all on ``a``'s device.  Returns (C, B)."""
    if a.dtype != torch.float32:
        raise TypeError(f"audio must be torch.float32, got {a.dtype}")
    if a.dim() != 2 or a.shape[1] < 1:
        raise ValueError(f"audio must be [C, B] with B >= 1, got "
                         f"{tuple(a.shape)}")
    C, B = a.shape
    delay, lg = state
    for name, t, shape in (("audio", a, (C, B)),
                           ("delay", delay, (C, op.lookahead))):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be torch.float32, got {t.dtype}")
        if tuple(t.shape) != shape or t.device != a.device:
            raise ValueError(f"{name} must be {shape} on {a.device}, got "
                             f"{tuple(t.shape)} on {t.device}")
        if (shape[1] > 1 and t.stride(1) != 1) or (
                C > 1 and t.stride(0) < shape[1]):
            raise ValueError(f"{name}: samples must be contiguous and rows "
                             f"must not overlap")
    if lg.dtype != torch.float32:
        raise TypeError(f"log gain must be torch.float32, got {lg.dtype}")
    if tuple(lg.shape) != (C,) or lg.device != a.device:
        raise ValueError(f"log gain must be {(C,)} on {a.device}, got "
                         f"{tuple(lg.shape)} on {lg.device}")
    _kernels.check_tensors(a, {
        name: (getattr(op, name), torch.float32, ())
        for name in ("target", "max_lgain", "release_inc")})
    return C, B


@functools.cache
def _launcher():
    fn = _kernels.load("agc_delay").agc_delay
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn.argtypes = [ptr, i64, ptr, i64, ptr, i64, ptr, ptr, ptr, ptr, ptr,
                   ptr, i32, i32, i32, ptr]
    fn.restype = ctypes.c_int
    return fn


def agc_delay(op: AGC, state, a: torch.Tensor):
    """``op``'s block on ``a``'s CUDA device in one kernel launch
    (``agc_delay.launches``): ((delay', lg'), out) as :meth:`AGC.plain`.
    The parameters are read on the card, so nothing waits on it."""
    if a.device.type != "cuda":
        raise ValueError(f"agc_delay: no kernel for device {a.device}")
    C, B = check(op, state, a)
    delay, lg = state
    W = op.lookahead
    out = torch.empty((C, B), dtype=torch.float32, device=a.device)
    d_out = torch.empty((C, W), dtype=torch.float32, device=a.device)
    lg_out = torch.empty((C,), dtype=torch.float32, device=a.device)
    err = _kernels.call(
        a, _launcher(), a.data_ptr(), a.stride(0) if C > 1 else B,
        delay.data_ptr(), delay.stride(0) if C > 1 else W, lg.data_ptr(),
        lg.stride(0), op.target.data_ptr(), op.max_lgain.data_ptr(),
        op.release_inc.data_ptr(), out.data_ptr(), d_out.data_ptr(),
        lg_out.data_ptr(), C, W, B)
    if err == _ERR_BAD_SHAPE:
        raise ValueError(f"agc_delay: shape {(C, W, B)} outside the "
                         f"kernel's limits")
    if err == _ERR_SHARED_MEMORY:
        raise ValueError(f"agc_delay: lookahead {W} + block {B} samples "
                         f"need more shared memory than a block may have")
    if err != 0:
        raise RuntimeError(f"agc_delay launch failed: CUDA error {err}")
    agc_delay.launches += 1
    return (d_out, lg_out), out


agc_delay.launches = 0


def _gain_limit(ext_abs: torch.Tensor, W: int, B: int, target, max_lgain):
    """Log of the largest gain that keeps each delayed sample's lookahead
    window at or under ``target``, capped at ``max_lgain``."""
    env = sliding_max(ext_abs, W)[:, :B]
    return torch.minimum(torch.log(target / torch.clamp(env, min=1e-9)),
                         max_lgain)


@dataclasses.dataclass(frozen=True)
class HangAGC:
    """wcpAGC-style AGC with a hang interval (wdsp/wcpAGC.c): the gain
    holds for ``hang_samples`` after a peak before the exponential
    recovery starts, so voice between syllables keeps a steady gain.  The
    gain limit comes from the lookahead sliding max (attack); a per-sample
    loop carries (log-gain, hang counter): the gain drops at once to the
    limit and rises only when the counter has expired.

    State: (delay [C, lookahead], log-gain [C], hang counter [C] int32)."""

    target: torch.Tensor
    max_lgain: torch.Tensor
    release_inc: torch.Tensor
    hang_samples: int
    lookahead: int

    @classmethod
    def create(cls, sample_rate: float, target: float = 0.9,
               max_gain_db: float = 80.0, release_db_per_s: float = 60.0,
               hang_ms: float = 250.0, lookahead_ms: float = 15.0,
               device=None):
        base = AGC.create(sample_rate, target, max_gain_db, release_db_per_s,
                          lookahead_ms, device=device)
        return cls(target=base.target, max_lgain=base.max_lgain,
                   release_inc=base.release_inc,
                   hang_samples=max(1, int(hang_ms * 1e-3 * sample_rate)),
                   lookahead=base.lookahead)

    def init_state(self, channels: int):
        dev = self.target.device
        return (torch.zeros((channels, self.lookahead), dtype=torch.float32,
                            device=dev),
                torch.zeros((channels,), dtype=torch.float32, device=dev),
                torch.zeros((channels,), dtype=torch.int32, device=dev))

    def scan_inputs(self, state, a: torch.Tensor):
        """(ext, (xs, carry, coef, params)): the delay line with the block,
        and the arguments of ``hang_scan`` for this block."""
        delay, lg0, hang0 = state
        W, B = self.lookahead, a.shape[-1]
        ext = torch.cat([delay, a], dim=-1)
        limit = _gain_limit(torch.abs(ext), W, B, self.target,
                            self.max_lgain)
        return ext, ((limit,), (lg0, hang0), self.release_inc.reshape(1),
                     {"hang_samples": self.hang_samples})

    def __call__(self, state, a: torch.Tensor):
        W, B = self.lookahead, a.shape[-1]
        ext, (xs, carry, coef, kw) = self.scan_inputs(state, a)
        (lg_f, hang_f), lg = hang_scan(*xs, carry, coef, **kw)
        return (ext[:, ext.shape[-1] - W:], lg_f, hang_f), (
            ext[:, :B] * torch.exp(lg))


_WCP_CARRY = ("volts", "save_volts", "fast_ba", "hang_ba", "hang_counter",
              "state", "decay_type")


@dataclasses.dataclass(frozen=True)
class WcpAGC:
    """Conformance-exact WDSP AGC (wdsp/wcpAGC.c:161-342 ``xwcpagc``).

    The full algorithm: attack_buffsize lookahead delay, sliding max of
    the envelope over the attack window, fast and hang back-averages of
    the output-side envelope, and the 5-state machine on ``volts``
    (0 attack/track, 1 fast decay after a pop, 2 hang hold, 3 normal
    decay, 4 post-hang decay), finished by the log-slope gain law
    ``mult = (out_target - slope*min(0, log10(volts/max_input)))/volts``.

    Held sample for sample to the float64 oracle (oracle/wcpagc.py).  The
    window max is block-parallel (van Herk); the state machine runs
    through ``ops.agc_scan.wcp_scan``: one kernel launch a block on a card,
    a per-sample loop with the channels vectorised on the CPU.

    ``k`` holds the derived constants (loadWcpAGC, wcpAGC.c:115-146) as
    0-dim float32 tensors.  State: a dict of delay [C, lookahead], volts,
    save_volts, fast_ba, hang_ba (float32 [C]) and hang_counter, state,
    decay_type (int32 [C])."""

    k: dict
    hang_samples: int
    hang_enable: bool
    lookahead: int

    @classmethod
    def create(cls, sample_rate: float, device=None, **overrides):
        device = resolve_device(device)
        p = WcpParams(sample_rate=sample_rate, **overrides)
        d = {**p.derived(), "pop_ratio": p.pop_ratio,
             "inv_max_input": 1.0 / p.max_input}
        k = {name: torch.tensor(np.float32(d[name]), device=device)
             for name in WCP_COEF}
        return cls(k=k, hang_samples=d["hangtime_samples"],
                   hang_enable=bool(p.hang_enable),
                   lookahead=p.attack_buffsize)

    def init_state(self, channels: int):
        dev = self.k["out_target"].device

        def z(dtype):
            return torch.zeros((channels,), dtype=dtype, device=dev)
        return {
            "delay": torch.zeros((channels, self.lookahead),
                                 dtype=torch.float32, device=dev),
            "volts": z(torch.float32), "save_volts": z(torch.float32),
            "fast_ba": z(torch.float32), "hang_ba": z(torch.float32),
            "hang_counter": z(torch.int32), "state": z(torch.int32),
            "decay_type": z(torch.int32),
        }

    def scan_inputs(self, state, a: torch.Tensor):
        """(ext, (xs, carry, coef, params)): the delay line with the block,
        and the arguments of ``wcp_scan`` for this block."""
        A, B = self.lookahead, a.shape[-1]
        ext = torch.cat([state["delay"], a], dim=-1)       # [C, A+B]
        env_ext = torch.abs(ext)
        # trailing attack-window max ending at each input sample: with the
        # carried samples this is the right-looking window at offset 1
        ring_max = sliding_max(env_ext[:, 1:], A)[:, :B]
        abs_out = env_ext[:, :B]                           # delayed by A
        return ext, ((ring_max, abs_out),
                     tuple(state[n] for n in _WCP_CARRY),
                     torch.stack([self.k[n] for n in WCP_COEF]),
                     {"hang_samples": self.hang_samples,
                      "hang_enable": self.hang_enable})

    def __call__(self, state, a: torch.Tensor):
        A, B = self.lookahead, a.shape[-1]
        ext, (xs, carry, coef, kw) = self.scan_inputs(state, a)
        carry, mult = wcp_scan(*xs, carry, coef, **kw)
        new_st = dict(zip(_WCP_CARRY, carry))
        new_st["delay"] = ext[:, ext.shape[-1] - A:]
        return new_st, ext[:, :B] * mult


_ALC_CARRY = ("gain_change", "final_gain", "next_change", "counter", "fault",
              "block_index")


@dataclasses.dataclass(frozen=True)
class TxALC:
    """TX ALC (microphone.c:270-358 ``process_alc``).

    20 ms lookahead delay; when a sample would clip at the gain it sees on
    leaving the delay, the gain ramps down linearly across the buffer to
    land exactly at the safe gain; recovery ramps are bounded by the
    observed headroom and by a gain-doubling time of ~5 s; the gain is
    clamped to [0.1, 3.0] and remembered per mode (``gain_now[mode]``), so
    returning to a mode restores its level.  Levels are normalised to 1.0
    full scale.

    As in ``quisk_tpu.ops.agc.TxALC``, the delay line stays out of the
    per-sample recurrence (the output is the input delayed by ``buf``
    samples times the gain trajectory) and the active mode's gain is
    gathered once a block and scattered back once a block, so the loop
    carries eight values per channel: the gain and ``gain_change``,
    ``final_gain``, ``next_change``, ``counter``, ``fault``,
    ``block_index``, ``index``.  The loop is ``ops.agc_scan.tx_alc_scan``:
    one kernel launch a block on a card, ~37 tensor ops a sample on the
    CPU.

    State: ``buffer`` complex64 [C, buf]; ``gain_now`` [C, n_modes];
    the float32 [C] carries above; ``block_index`` int32 [C]; ``index``
    int32 0-dim."""

    target: torch.Tensor
    gain_max: torch.Tensor
    gain_min: torch.Tensor
    d_limit: torch.Tensor           # per-sample gain increase bound
    min_magn: torch.Tensor          # silence floor (ref: 100 counts)
    mode: torch.Tensor              # [C] int64 active mode per channel
    buf: int
    n_modes: int = 14

    @classmethod
    def create(cls, sample_rate: float, mode=0, channels: int = 1,
               buf_ms: float = 20.0, clip_level: float = 1.0,
               gain_max: float = 3.0, gain_min: float = 0.1,
               double_secs: float = 5.0, n_modes: int = 14,
               device=None) -> "TxALC":
        device = resolve_device(device)
        A = int(sample_rate * buf_ms / 1000.0)
        m = np.broadcast_to(np.asarray(mode, np.int64), (channels,))

        def f32(v):
            return torch.tensor(np.float32(v), device=device)
        return cls(target=f32(clip_level * (32767.0 - 10.0) / 32767.0),
                   gain_max=f32(gain_max), gain_min=f32(gain_min),
                   d_limit=f32(1.0 / (48000.0 * double_secs)),
                   min_magn=f32(100.0 / 32758.0),
                   mode=torch.as_tensor(m.copy(), device=device), buf=A,
                   n_modes=n_modes)

    def init_state(self, channels: int):
        dev = self.target.device

        def z(v=0.0):
            return torch.full((channels,), v, dtype=torch.float32, device=dev)
        return {
            "buffer": torch.zeros((channels, self.buf), dtype=torch.complex64,
                                  device=dev),
            "gain_now": torch.ones((channels, self.n_modes),
                                   dtype=torch.float32, device=dev),
            "gain_change": z(), "final_gain": z(), "next_change": z(1e10),
            "counter": z(), "fault": z(),
            "block_index": torch.zeros((channels,), dtype=torch.int32,
                                       device=dev),
            "index": torch.zeros((), dtype=torch.int32, device=dev),
        }

    def __call__(self, state, x: torch.Tensor):
        st, out, _ = self._step(state, x, False)
        return st, out

    def trace(self, state, x: torch.Tensor):
        """As ``__call__``, and also the per-sample clip decisions
        [C, B] bool: (state, out, clips)."""
        return self._step(state, x, True)

    def scan_inputs(self, state, x: torch.Tensor):
        """(ext, (xs, carry, coef, params)): the delay line with the block,
        and the arguments of ``tx_alc_scan`` for this block (the carry
        starts from the active mode's gain)."""
        st = state
        ext = torch.cat([st["buffer"], x.to(torch.complex64)], dim=-1)
        # |x| as mul, add, sqrt: correctly rounded element ops, so the card
        # and the CPU see the same magnitudes and take the same branches
        magn = torch.sqrt(x.real * x.real + x.imag * x.imag).to(torch.float32)
        g0 = st["gain_now"].gather(1, self.mode[:, None])[:, 0]
        coef = torch.stack([self.target, self.gain_min, self.gain_max,
                            self.d_limit, self.min_magn])
        carry = (g0,) + tuple(st[k] for k in _ALC_CARRY) + (st["index"],)
        return ext, ((magn,), carry, coef, {"buf": self.buf})

    def _step(self, state, x: torch.Tensor, with_clips: bool):
        st, B, A = state, x.shape[-1], self.buf
        ext, (xs, carry0, coef, kw) = self.scan_inputs(state, x)
        carry, gains, clips = tx_alc_scan(*xs, carry0, coef, **kw,
                                          clips=with_clips)
        g0 = carry0[0]
        new_st = dict(zip(_ALC_CARRY + ("index",), carry[1:]))
        new_st["buffer"] = ext[:, ext.shape[-1] - A:]
        onehot = torch.nn.functional.one_hot(
            self.mode, self.n_modes).to(torch.float32)
        new_st["gain_now"] = (st["gain_now"]
                              + (carry[0] - g0)[:, None] * onehot)
        return new_st, ext[:, :B] * gains, clips
