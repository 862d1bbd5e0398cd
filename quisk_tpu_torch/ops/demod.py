"""Demodulators: SSB/CW, AM, FM, a branch-free mixed-mode batch, and the
grouped demods of the channelizer.

Parity targets in the reference (quisk.c:1848 ``quisk_process_demodulate``):

- SSB/CW (quisk.c:1910-2001): after the analytic channel filter, audio is
  2*Re of the filter output.
- AM (quisk.c:2002-2025): envelope |x| then a one-pole DC blocker.
- FM (quisk.c:2026-2086): phase-difference discriminator
  arg(x[n] * conj(x[n-1])) then one-pole de-emphasis at 300 Hz.
- PLL FM (wdsp/fmd.c xfmd): a carrier-tracking second-order loop whose
  frequency estimate is the audio, run by the PLL kernel (ops/pll.py),
  then de-emphasis and an optional CTCSS notch.

The mixed-mode batch computes every family on every channel and selects
per channel by the ``mode`` vector, which is data: on a card in one launch
of ``csrc/mixed_demod.cu`` (:func:`mixed_demod`), on the CPU as torch ops
with ``torch.where`` (:meth:`MixedDemod.plain`).  The grouped demods
(:class:`GroupedDemod` channel-major, :class:`GroupedDemodTM` time-major on
(re, im) planes) run each family only on its own contiguous run of
channels, fixed at ``create``: the PFB channelizer's channel -> mode plan.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from quisk_tpu_torch import _kernels
from quisk_tpu_torch._device import resolve_device
from quisk_tpu_torch.modes import Mode
from quisk_tpu_torch.ops.iir import Biquad, DCBlock, OnePole
from quisk_tpu_torch.ops.pll import pll_fm
from quisk_tpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class SSBDemod:
    """Analytic-signal SSB/CW demod: audio = gain*Re(x).  Stateless."""

    gain: torch.Tensor

    @classmethod
    def create(cls, device, gain: float = 2.0):
        return cls(gain=torch.tensor(gain, dtype=torch.float32, device=device))

    def init_state(self, channels: int):
        return ()

    def __call__(self, state, x: torch.Tensor):
        return state, self.gain * x.real


@dataclasses.dataclass(frozen=True)
class AMDemod:
    """Envelope detector with DC removal.  State: (x_prev, y_prev)."""

    dc: DCBlock
    gain: torch.Tensor

    @classmethod
    def create(cls, device, gain: float = 2.0, pole: float = 0.995):
        return cls(dc=DCBlock.create(device, pole),
                   gain=torch.tensor(gain, dtype=torch.float32, device=device))

    def init_state(self, channels: int):
        return self.dc.init_state(channels)

    def __call__(self, state, x: torch.Tensor):
        state, audio = self.dc(state, torch.abs(x))
        return state, self.gain * audio

    def envelope(self, x: torch.Tensor) -> torch.Tensor:
        return torch.abs(x)


@dataclasses.dataclass(frozen=True)
class FMDemod:
    """Phase-difference discriminator with de-emphasis.

    ``gain = fs / (2 pi deviation)`` maps full deviation to audio +-1.
    State: (prev complex sample [C], de-emphasis y_prev [C]).
    """

    deemph: OnePole
    gain: torch.Tensor

    @classmethod
    def create(cls, sample_rate: float, device, deviation_hz: float = 5000.0,
               deemph_hz: float = 300.0):
        g = sample_rate / (2.0 * np.pi * deviation_hz)
        return cls(deemph=OnePole.lowpass(deemph_hz, sample_rate, device),
                   gain=torch.tensor(g, dtype=torch.float32, device=device))

    def init_state(self, channels: int):
        return (torch.zeros((channels,), dtype=torch.complex64,
                            device=self.gain.device),
                self.deemph.init_state(channels))

    def discriminate(self, prev: torch.Tensor, x: torch.Tensor):
        xm1 = torch.cat([prev[:, None], x[:, :-1]], dim=-1)
        d = x * torch.conj(xm1)
        # Gate vanishing magnitudes (filter warm-up, dead air): the angle of
        # a ~1e-7 residual is numerical noise whose sign flips with one-ulp
        # differences in the sums before it; emit 0 there.
        disc = torch.where(torch.abs(d) > 1e-12,
                           torch.atan2(d.imag, d.real),
                           torch.zeros((), dtype=torch.float32,
                                       device=x.device))
        return x[:, -1], disc

    def __call__(self, state, x: torch.Tensor):
        prev, y_prev = state
        prev, disc = self.discriminate(prev, x)
        y_prev, audio = self.deemph(y_prev, disc * self.gain)
        return (prev, y_prev), audio


@dataclasses.dataclass(frozen=True)
class PLLFMDemod:
    """FM discriminator by carrier-tracking PLL (parity wdsp/fmd.c xfmd).

    A second-order loop tracks the instantaneous phase; the audio is the
    loop's frequency estimate (smoother under noise than the
    phase-difference discriminator, which is why WDSP uses it for NFM).
    An optional CTCSS notch removes the sub-audible tone (fmd.c snotch).

    State: (phase [C], freq [C], deemph y_prev [C], notch state or ()).
    The loop runs in the PLL kernel's FM mode (ops/pll.py).  The loop, the
    de-emphasis and the notch each run inside a span of their own
    (``rx.pll``, ``rx.deemph``, ``rx.ctcss``)."""

    deemph: OnePole
    notch: Biquad | None
    alpha: torch.Tensor
    beta: torch.Tensor
    gain: torch.Tensor         # audio units per rad/sample
    max_freq: torch.Tensor

    @classmethod
    def create(cls, sample_rate: float, deviation_hz: float = 5000.0,
               loop_bw_hz: float = 5000.0, deemph_hz: float = 300.0,
               ctcss_hz: float = 0.0, max_offset_hz: float = 10000.0,
               device=None):
        device = resolve_device(device)
        wn = 2.0 * np.pi * loop_bw_hz / sample_rate
        zeta = 0.707
        g = sample_rate / (2.0 * np.pi * deviation_hz)
        notch = (Biquad.notch(ctcss_hz, sample_rate, device, q=5.0)
                 if ctcss_hz > 0.0 else None)

        def f32(v):
            return torch.tensor(np.float32(v), device=device)

        return cls(deemph=OnePole.lowpass(deemph_hz, sample_rate, device),
                   notch=notch, alpha=f32(2.0 * zeta * wn), beta=f32(wn * wn),
                   gain=f32(g),
                   max_freq=f32(2.0 * np.pi * max_offset_hz / sample_rate))

    def init_state(self, channels: int):
        z = torch.zeros((channels,), dtype=torch.float32,
                        device=self.alpha.device)
        notch_st = (self.notch.init_state(channels)
                    if self.notch is not None else ())
        return (z, z, self.deemph.init_state(channels), notch_st)

    def coef(self) -> torch.Tensor:
        """The PLL kernel's (alpha, beta, max_freq, gain)."""
        return torch.stack([self.alpha, self.beta, self.max_freq, self.gain])

    def __call__(self, state, x: torch.Tensor):
        phase0, freq0, de0, notch_st = state
        with span("rx.pll"):
            (ph, fr), audio = pll_fm(x, (phase0, freq0), self.coef())
        with span("rx.deemph"):
            de0, audio = self.deemph(de0, audio)
        if self.notch is not None:
            with span("rx.ctcss"):
                notch_st, audio = self.notch(notch_st, audio)
        return (ph, fr, de0, notch_st), audio


# Custom demodulator plugin slot (extdemod.c parity): a registry of ops.
# A custom demod is any (state, x [C, B] complex) -> (state, audio [C, B])
# op with init_state(channels); channels whose mode is Mode.EXT use it.
_EXT_DEMODS: dict[str, object] = {}


def register_ext_demod(name: str, factory) -> None:
    """factory(sample_rate, channels, device) -> demod op.  ``"pll_fm"``
    is built by :func:`make_ext_demod` from the chain's configuration; a
    factory registered under that name is not used."""
    _EXT_DEMODS[name] = factory


def get_ext_demod(name: str):
    return _EXT_DEMODS[name]


def make_ext_demod(name: str, sample_rate: float, channels: int, device,
                   deviation_hz: float = 5000.0, ctcss_hz: float = 0.0):
    """The EXT demodulator ``name``: ``"pll_fm"`` is WDSP's FM receiver
    (:class:`PLLFMDemod` at ``deviation_hz``, with the CTCSS notch at
    ``ctcss_hz`` when it is above 0); any other name is the factory
    registered under it (``KeyError`` if none is)."""
    if name == "pll_fm":
        return PLLFMDemod.create(sample_rate, deviation_hz=deviation_hz,
                                 ctcss_hz=ctcss_hz, device=device)
    return get_ext_demod(name)(sample_rate, channels, device)


@dataclasses.dataclass(frozen=True)
class MixedDemod:
    """Per-channel mode selection over a shared ``[C, B]`` batch.

    Every family is computed and the per-channel result selected by the
    ``mode`` vector (quisk.c:1909-2153 with the branches as data); every
    family's state advances on every channel, so a channel retuned to
    another family goes on from a warm state.  Any channel created as
    DGT_IQ makes the chain's audio complex64 (``iq_out``): those rows carry
    the raw filtered IQ.
    """

    ssb: SSBDemod
    am: AMDemod
    fm: FMDemod
    ext: object                # custom demod op | None
    mode: torch.Tensor         # [C] int32
    iq_out: bool = False

    @classmethod
    def create(cls, mode, sample_rate: float, channels: int,
               fm_deviation_hz: float = 5000.0, ext_demod: str | None = None,
               device=None, ctcss_hz: float = 0.0):
        device = resolve_device(device)
        m_np = np.broadcast_to(np.asarray(mode, np.int32), (channels,))
        ext = (make_ext_demod(ext_demod, sample_rate, channels, device,
                              fm_deviation_hz, ctcss_hz)
               if ext_demod else None)
        return cls(ssb=SSBDemod.create(device), am=AMDemod.create(device),
                   fm=FMDemod.create(sample_rate, device, fm_deviation_hz),
                   ext=ext, mode=torch.as_tensor(m_np.copy(), device=device),
                   iq_out=bool(np.any(m_np == int(Mode.DGT_IQ))))

    def init_state(self, channels: int):
        ext_st = self.ext.init_state(channels) if self.ext is not None else ()
        return (self.am.init_state(channels), self.fm.init_state(channels),
                ext_st)

    def __call__(self, state, x: torch.Tensor):
        """x [C, B] complex64 -> (state, audio [C, B] float32).  A CUDA
        tensor runs the EXT op, if any, then launches the kernel once
        (:func:`mixed_demod`); a CPU tensor runs :meth:`plain`; any other
        device raises."""
        if x.device.type == "cpu":
            return self.plain(state, x)
        am_st, fm_st, ext_st = state
        a_ext = None
        if self.ext is not None:
            ext_st, a_ext = self.ext(ext_st, x)
        (am_st, fm_st), audio = mixed_demod(self, am_st, fm_st, x, a_ext)
        return (am_st, fm_st, ext_st), audio

    def params(self) -> tuple:
        """The kernel's six 0-dim parameters: SSB gain, AM gain, the DC
        blocker's pole, FM gain, the de-emphasis's a and b."""
        return (self.ssb.gain, self.am.gain, self.am.dc.a, self.fm.gain,
                self.fm.deemph.a, self.fm.deemph.b)

    def plain(self, state, x: torch.Tensor):
        """The block as torch ops on any device: every family, then
        ``torch.where`` by the mode."""
        am_st, fm_st, ext_st = state
        _, a_ssb = self.ssb((), x)
        am_st, a_am = self.am(am_st, x)
        fm_st, a_fm = self.fm(fm_st, x)
        m = self.mode[:, None]
        audio = torch.where(m == int(Mode.AM), a_am,
                            torch.where(m == int(Mode.FM), a_fm, a_ssb))
        if self.ext is not None:
            ext_st, a_ext = self.ext(ext_st, x)
            audio = torch.where(m == int(Mode.EXT), a_ext, audio)
        return (am_st, fm_st, ext_st), audio


_ERR_BAD_SHAPE = -1                          # the launcher's error code


def check(op: MixedDemod, am_st, fm_st, x: torch.Tensor, a_ext
          ) -> tuple[int, int]:
    """What :func:`mixed_demod` checks first: ``x`` [C, B] complex64 (C, B
    >= 1), the mode [C] int32,
    the AM state (x_prev, y_prev) [C] float32, the FM state (prev [C]
    complex64, y_prev [C] float32), the EXT audio (None, or [C, B]
    float32) and the six 0-dim float32 parameters, all on ``x``'s device.
    Returns (C, B)."""
    if x.dtype != torch.complex64:
        raise TypeError(f"samples must be torch.complex64, got {x.dtype}")
    if x.dim() != 2 or x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"samples must be [C, B] with C, B >= 1, got "
                         f"{tuple(x.shape)}")
    C, B = x.shape
    (ax, ay), (fp, fy) = am_st, fm_st
    for name, t, dt in (("mode", op.mode, torch.int32),
                        ("AM x_prev", ax, torch.float32),
                        ("AM y_prev", ay, torch.float32),
                        ("FM prev", fp, torch.complex64),
                        ("FM y_prev", fy, torch.float32)):
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if tuple(t.shape) != (C,) or t.device != x.device:
            raise ValueError(f"{name} must be {(C,)} on {x.device}, got "
                             f"{tuple(t.shape)} on {t.device}")
    if a_ext is not None:
        if a_ext.dtype != torch.float32:
            raise TypeError(f"EXT audio must be torch.float32, got "
                            f"{a_ext.dtype}")
        if tuple(a_ext.shape) != (C, B) or a_ext.device != x.device:
            raise ValueError(f"EXT audio must be {(C, B)} on {x.device}, "
                             f"got {tuple(a_ext.shape)} on {a_ext.device}")
    _kernels.check_tensors(x, {
        name: (t, torch.float32, ())
        for name, t in zip(("ssb gain", "AM gain", "AM pole", "FM gain",
                            "de-emphasis a", "de-emphasis b"),
                           op.params())})
    return C, B


@functools.cache
def _launcher():
    fn = _kernels.load("mixed_demod").mixed_demod
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn.argtypes = [ptr, i64] * 7 + [ptr] * 8 + [i32] * 5 + [ptr]
    fn.restype = ctypes.c_int
    return fn


def mixed_demod(op: MixedDemod, am_st, fm_st, x: torch.Tensor,
                a_ext: torch.Tensor | None = None):
    """``op``'s families and selection on ``x``'s CUDA device in one kernel
    launch (``mixed_demod.launches``): ((AM state', FM state'), audio) as
    :meth:`MixedDemod.plain` gives them, the EXT rows taking ``a_ext``
    (the EXT op's audio, already computed).  The mode and the parameters
    are read on the card, so nothing waits on it and a retune needs no
    rebuild."""
    if x.device.type != "cuda":
        raise ValueError(f"mixed_demod: no kernel for device {x.device}")
    C, B = check(op, am_st, fm_st, x, a_ext)
    # the kernel reads each row's samples in order: a time-major caller's
    # view (the PFB's [.., time, channel] planes transposed) is copied once
    x, a_ext = (t if t is None or B == 1 or t.stride(1) == 1
                else t.contiguous() for t in (x, a_ext))
    out = torch.empty((C, B), dtype=torch.float32, device=x.device)
    st = torch.empty((5 * C,), dtype=torch.float32, device=x.device)
    (ax, ay), (fp, fy) = am_st, fm_st
    err = _kernels.call(
        x, _launcher(), x.data_ptr(), x.stride(0) if C > 1 else B,
        *(v for t in (op.mode, ax, ay, fp, fy)
          for v in (t.data_ptr(), t.stride(0))),
        a_ext.data_ptr() if a_ext is not None else None,
        a_ext.stride(0) if a_ext is not None and C > 1 else B,
        *(t.data_ptr() for t in op.params()), out.data_ptr(), st.data_ptr(),
        C, B, int(Mode.AM), int(Mode.FM), int(Mode.EXT))
    if err == _ERR_BAD_SHAPE:
        raise ValueError(f"mixed_demod: shape {(C, B)} outside the kernel's "
                         f"limits")
    if err != 0:
        raise RuntimeError(f"mixed_demod launch failed: CUDA error {err}")
    mixed_demod.launches += 1
    prev = torch.view_as_complex(st[:2 * C].view(C, 2))
    ax, ay, fy = st[2 * C:].view(3, C).unbind(0)
    return ((ax, ay), (prev, fy)), out


mixed_demod.launches = 0


_FAMILIES = {int(Mode.AM): "am", int(Mode.FM): "fm"}


def mode_runs(mode, channels: int) -> tuple:
    """((family, lo, hi), ...): the contiguous runs of channels of one
    demod family ("ssb", "am" or "fm") in a mode vector."""
    m = np.broadcast_to(np.asarray(mode, np.int32), (channels,))
    fam = [_FAMILIES.get(int(v), "ssb") for v in m]
    edges = [0] + [i for i in range(1, channels)
                   if fam[i] != fam[i - 1]] + [channels]
    return tuple((fam[lo], lo, hi) for lo, hi in zip(edges[:-1], edges[1:]))


@dataclasses.dataclass(frozen=True)
class GroupedDemod:
    """Mode demodulation over contiguous per-mode channel runs.

    Where :class:`MixedDemod` computes every family on every channel and
    selects, this slices each run of same-family channels and runs only
    its own demod.  The grouping is fixed at ``create`` (the channelizer's
    channel -> mode plan); per-channel retuning stays with MixedDemod.
    State: one demod state per run."""

    ssb: SSBDemod
    am: AMDemod
    fm: FMDemod
    runs: tuple                # ((family, lo, hi), ...)

    @classmethod
    def create(cls, mode, sample_rate: float, channels: int,
               fm_deviation_hz: float = 5000.0, device=None):
        device = resolve_device(device)
        return cls(ssb=SSBDemod.create(device), am=AMDemod.create(device),
                   fm=FMDemod.create(sample_rate, device, fm_deviation_hz),
                   runs=mode_runs(mode, channels))

    def init_state(self, channels: int):
        return tuple(getattr(self, f).init_state(hi - lo)
                     for f, lo, hi in self.runs)

    def __call__(self, state, x: torch.Tensor):
        new_states, outs = [], []
        for st, (f, lo, hi) in zip(state, self.runs):
            st, a = getattr(self, f)(st, x[lo:hi])
            new_states.append(st)
            outs.append(a)
        return tuple(new_states), torch.cat(outs, dim=0)


@dataclasses.dataclass(frozen=True)
class GroupedDemodTM:
    """Time-major grouped demod over (re, im) float planes ``[..., T, C]``:
    time on axis -2, channels last, as the PFB's cross-branch IDFT leaves
    them, so the channel-major complex batch is never formed.  Per family
    the math of :class:`GroupedDemod`:

    - SSB/CW: audio = gain * re;
    - AM: envelope, then the DC blocker (time-major one-pole);
    - FM: phase-difference discriminator (gated where the squared
      magnitude of z[t] conj(z[t-1]) is below 1e-24), then de-emphasis.

    All state is real float32 (FM's previous sample is an (re, im) pair);
    leading axes (the stream axis) broadcast through."""

    am_dc: DCBlock
    fm_deemph: OnePole
    ssb_gain: torch.Tensor
    am_gain: torch.Tensor
    fm_gain: torch.Tensor
    runs: tuple                # ((family, lo, hi), ...)

    @classmethod
    def create(cls, mode, sample_rate: float, channels: int,
               fm_deviation_hz: float = 5000.0, gain: float = 2.0,
               deemph_hz: float = 300.0, am_pole: float = 0.995,
               device=None):
        device = resolve_device(device)
        g_fm = sample_rate / (2.0 * np.pi * fm_deviation_hz)

        def f32(v):
            return torch.tensor(v, dtype=torch.float32, device=device)

        return cls(am_dc=DCBlock.create(device, am_pole),
                   fm_deemph=OnePole.lowpass(deemph_hz, sample_rate, device),
                   ssb_gain=f32(gain), am_gain=f32(gain), fm_gain=f32(g_fm),
                   runs=mode_runs(mode, channels))

    def init_state(self, channels: int, lead: tuple = ()):
        dev = self.ssb_gain.device
        count = {"ssb": 0, "am": 2, "fm": 3}     # am: (x_prev, y_prev);
        #                                          fm: (prev re, prev im, y)
        return tuple(tuple(torch.zeros((*lead, hi - lo), dtype=torch.float32,
                                       device=dev) for _ in range(count[f]))
                     for f, lo, hi in self.runs)

    def _ssb(self, st, yr, yi):
        return st, self.ssb_gain * yr

    def _am(self, st, yr, yi):
        st, audio = self.am_dc.apply_tm(st, torch.sqrt(yr * yr + yi * yi))
        return st, self.am_gain * audio

    def _fm(self, st, yr, yi):
        pr, pi, de = st
        xr1 = torch.cat([pr[..., None, :], yr[..., :-1, :]], dim=-2)
        xi1 = torch.cat([pi[..., None, :], yi[..., :-1, :]], dim=-2)
        dr = yr * xr1 + yi * xi1
        di = yi * xr1 - yr * xi1
        disc = torch.where(dr * dr + di * di > 1e-24, torch.atan2(di, dr),
                           torch.zeros((), dtype=yr.dtype, device=yr.device))
        de, audio = self.fm_deemph.apply_tm(de, disc * self.fm_gain)
        return (yr[..., -1, :], yi[..., -1, :], de), audio

    def __call__(self, state, yr: torch.Tensor, yi: torch.Tensor):
        """(state, yr, yi) -> (state, audio [..., T, C])."""
        new_states, outs = [], []
        for st, (f, lo, hi) in zip(state, self.runs):
            st, a = getattr(self, "_" + f)(st, yr[..., lo:hi],
                                           yi[..., lo:hi])
            new_states.append(st)
            outs.append(a)
        return tuple(new_states), torch.cat(outs, dim=-1)
