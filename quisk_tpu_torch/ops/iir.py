"""First- and second-order IIR sections as parallel recurrences.

One-pole filters sit in the demod chain: AM DC removal (quisk.c:2002-2025)
and FM de-emphasis (quisk.c:2057-2064).  ``y[n] = a*y[n-1] + b*x[n]`` is
a composition of affine maps, evaluated over the block axis in log-depth
(Hillis-Steele doubling), vectorised over channels; the carried state is
the last output sample.  :class:`FirstOrder` runs it channel-major or
time-major (``apply_tm``), long blocks in the chunked form of
``quisk_tpu.ops.iir`` (the sums grouped as the reference's), with
constants that :class:`OnePole`, :class:`DCBlock` and
:class:`PhaseRotator` build once, when made.  :class:`Biquad` runs in one
launch of ``csrc/biquad.cu`` on a card (:func:`biquad_df1`: the direct
form I recurrence in float64, one thread a channel); on the CPU its plain
version, :meth:`Biquad.plain`, runs the same log-step scan over 2x2 affine
maps, in float64.  The TX path's :class:`Preemphasis` is a first
difference and :class:`PhaseRotator` a cascade of first-order allpass
sections on the same scan.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from quisk_tpu_torch import _kernels
from quisk_tpu_torch._device import resolve_device


def affine_scan(A: torch.Tensor, Bv: torch.Tensor, dim: int = -1):
    """Inclusive scan of the maps ``y -> A[n] y + Bv[n]`` along axis ``dim``
    (the last by default): returns (A_cum, B_cum) with
    y[n] = B_cum[n] + A_cum[n] * y[-1]."""
    n = A.shape[dim]
    s = 1
    while s < n:
        lo, hi = A.narrow(dim, 0, s), A.narrow(dim, s, n - s)
        Bv = torch.cat([Bv.narrow(dim, 0, s),
                        hi * Bv.narrow(dim, 0, n - s)
                        + Bv.narrow(dim, s, n - s)], dim=dim)
        A = torch.cat([lo, hi * A.narrow(dim, 0, n - s)], dim=dim)
        s *= 2
    return A, Bv


_L = 128                                    # the chunked form's chunk


@dataclasses.dataclass(frozen=True)
class FirstOrder:
    """y[n] = a*y[n-1] + b*x[n] along axis ``dim`` of x: -1 (x [C, B],
    y_prev [C]) or -2, time-major (x [..., T, C], y_prev [..., C]).  With
    scalar ``a``, >= 2048 samples, a multiple of L, it is chunked: in chunk
    j (carry c_j) y[n] = a^(n+1) c_j + sum_k T[n, k] u[k], T = a^(n-k) on
    and below the diagonal, and c_{j+1} = a^L c_j + e_j, a short affine
    scan; else the log-step scan.  Powers are |a|^d sign(a)^d: a float
    power of a negative base is NaN."""

    a: torch.Tensor
    b: torch.Tensor
    T: torch.Tensor | None = None
    decay: torch.Tensor | None = None
    aL: torch.Tensor | None = None

    @classmethod
    def create(cls, a, b, like: torch.Tensor) -> "FirstOrder":
        """a, b, T, the decay a^(n+1) and a^L in ``like``'s dtype and on
        its device."""
        dt, dev = like.dtype, like.device
        a = torch.as_tensor(a, dtype=dt, device=dev)
        b = torch.as_tensor(b, dtype=dt, device=dev)
        if a.ndim:
            return cls(a, b)
        n = torch.arange(_L, device=dev)
        d, n1 = n[:, None] - n[None, :], n + 1
        dm = torch.clamp(d, min=0).to(dt)
        one = torch.ones((), dtype=dt, device=dev)
        sgn, mag = torch.where(a < 0, -one, one), torch.abs(a)
        pw = (mag ** dm) * torch.where(dm % 2 == 0, one, sgn)
        T = torch.where(d >= 0, pw, torch.zeros_like(pw))
        decay = (mag ** n1.to(dt)) * torch.where(n1 % 2 == 0, one, sgn)
        return cls(a, b, T, decay, mag ** _L)            # L even: |a|^L

    def __call__(self, x: torch.Tensor, y_prev: torch.Tensor,
                 dim: int = -1) -> torch.Tensor:
        n = x.shape[dim]
        if self.T is None or n < 2048 or n % _L:
            A_cum, B_cum = affine_scan(torch.broadcast_to(self.a, x.shape),
                                       self.b * x, dim=dim)
            return B_cum + A_cum * y_prev.unsqueeze(dim)
        nch = n // _L
        u = (self.b * x).unflatten(dim, (nch, _L))
        # each layout keeps its own orientation of the in-chunk product
        if dim == -1:
            yin, decay = torch.matmul(u, self.T.T), self.decay  # [.., nch, L]
        else:
            yin, decay = torch.matmul(self.T, u), self.decay[:, None]
        e = yin.select(dim, -1)                            # chunk sums
        Acum, Ecum = affine_scan(torch.broadcast_to(self.aL, e.shape), e,
                                 dim=dim)
        yp = y_prev.unsqueeze(dim)
        s = Ecum + Acum * yp                               # chunk end states
        c = torch.cat([yp, s.narrow(dim, 0, nch - 1)], dim=dim)
        return (yin + c.unsqueeze(dim) * decay).reshape(x.shape)


def first_order_scan(x: torch.Tensor, a, b, y_prev: torch.Tensor,
                     dim: int = -1) -> torch.Tensor:
    """All outputs of y[n] = a*y[n-1] + b*x[n] along axis ``dim`` given
    y[-1] = y_prev, for bare coefficients (scalar, 0-dim or [C, 1]): the
    constants of :class:`FirstOrder` are built for this call."""
    return FirstOrder.create(a, b, x)(x, y_prev, dim)


@dataclasses.dataclass(frozen=True)
class OnePole:
    """y[n] = a*y[n-1] + b*x[n].  Lowpass: a = exp(-2 pi fc / fs), b = 1-a.
    ``k``, its :class:`FirstOrder`, is built when made (not a field, as in
    :class:`DCBlock` and :class:`PhaseRotator`: ``replace`` rebuilds it)."""

    a: torch.Tensor
    b: torch.Tensor

    def __post_init__(self):
        object.__setattr__(self, "k", FirstOrder.create(self.a, self.b,
                                                        self.a))

    @classmethod
    def lowpass(cls, fc_hz: float, fs: float, device):
        a = float(np.exp(-2.0 * np.pi * fc_hz / fs))
        return cls(a=torch.tensor(a, dtype=torch.float32, device=device),
                   b=torch.tensor(1.0 - a, dtype=torch.float32,
                                  device=device))

    def init_state(self, channels: int) -> torch.Tensor:
        return torch.zeros((channels,), dtype=torch.float32,
                           device=self.a.device)

    def __call__(self, y_prev: torch.Tensor, x: torch.Tensor):
        y = self.k(x, y_prev)
        return y[:, -1], y

    def apply_tm(self, y_prev: torch.Tensor, x: torch.Tensor):
        """Time-major form: x [..., T, C], y_prev [..., C]."""
        y = self.k(x, y_prev, dim=-2)
        return y[..., -1, :], y


@dataclasses.dataclass(frozen=True)
class DCBlock:
    """DC blocker y[n] = x[n] - x[n-1] + a*y[n-1] (Lyons; the reference's
    AM path).  State is (x_prev [C], y_prev [C])."""

    a: torch.Tensor

    def __post_init__(self):
        object.__setattr__(self, "k", FirstOrder.create(self.a, 1.0, self.a))

    @classmethod
    def create(cls, device, pole: float = 0.995):
        return cls(a=torch.tensor(pole, dtype=torch.float32, device=device))

    def init_state(self, channels: int):
        z = torch.zeros((channels,), dtype=torch.float32,
                        device=self.a.device)
        return z, z

    def __call__(self, state, x: torch.Tensor):
        x_prev, y_prev = state
        d = x - torch.cat([x_prev[:, None], x[:, :-1]], dim=-1)
        y = self.k(d, y_prev)
        return (x[:, -1], y[:, -1]), y

    def apply_tm(self, state, x: torch.Tensor):
        """Time-major form: x [..., T, C], the state pair [..., C] each."""
        x_prev, y_prev = state
        d = x - torch.cat([x_prev[..., None, :], x[..., :-1, :]], dim=-2)
        y = self.k(d, y_prev, dim=-2)
        return (x[..., -1, :], y[..., -1, :]), y


def _rbj(b0, b1, b2, a1, a2, a0, device) -> "Biquad":
    return Biquad(*(torch.tensor(np.float32(v / a0), device=device)
                    for v in (b0, b1, b2, a1, a2)))


@dataclasses.dataclass(frozen=True)
class Biquad:
    """Second-order IIR section (direct form I, wdsp/iir.c snotch / speak /
    mpeak).  On a card one kernel launch a block steps the recurrence a
    sample at a time, one thread a channel (:func:`biquad_df1`).  The plain
    version runs it as a parallel recurrence: the feedback pair
    (y[n-1], y[n-2]) evolves linearly, s[n] = A s[n-1] + [f[n], 0], so the
    block is a log-step scan over 2x2 affine maps.  A is the same at every
    step: its running products A^(n+1) are scanned once per block as
    [B, 2, 2] and shared by all channels.

    Both routes carry the feedforward sum and the recurrence in float64 and
    round the output and the state to float32: in float32 the zeros'
    cancellation and the matrix powers of a pole pair near the unit circle
    lose every digit (the CTCSS notch, 100 Hz at q=5 and 48 kS/s, came out
    ~1 dB from the float64 recurrence on noise; the JAX op's float32 scan,
    in another tree order, ~26 dB).

    State: (x1, x2, y1, y2), each [C] float32."""

    b0: torch.Tensor
    b1: torch.Tensor
    b2: torch.Tensor
    a1: torch.Tensor
    a2: torch.Tensor

    @classmethod
    def notch(cls, f0_hz: float, fs: float, device, q: float = 30.0):
        """RBJ cookbook notch (zero at f0)."""
        w0 = 2.0 * np.pi * f0_hz / fs
        alpha = np.sin(w0) / (2.0 * q)
        c = np.cos(w0)
        return _rbj(1.0, -2.0 * c, 1.0, -2.0 * c, 1.0 - alpha, 1.0 + alpha,
                    device)

    @classmethod
    def peak(cls, f0_hz: float, fs: float, device, q: float = 10.0,
             gain_db: float = 12.0):
        """RBJ peaking EQ."""
        A = 10.0 ** (gain_db / 40.0)
        w0 = 2.0 * np.pi * f0_hz / fs
        alpha = np.sin(w0) / (2.0 * q)
        c = np.cos(w0)
        return _rbj(1.0 + alpha * A, -2.0 * c, 1.0 - alpha * A, -2.0 * c,
                    1.0 - alpha, 1.0 + alpha / A, device)

    @classmethod
    def highpass(cls, f0_hz: float, fs: float, device, q: float = 0.7071):
        w0 = 2.0 * np.pi * f0_hz / fs
        alpha = np.sin(w0) / (2.0 * q)
        c = np.cos(w0)
        return _rbj((1.0 + c) / 2.0, -(1.0 + c), (1.0 + c) / 2.0, -2.0 * c,
                    1.0 - alpha, 1.0 + alpha, device)

    def init_state(self, channels: int):
        z = torch.zeros((channels,), dtype=torch.float32,
                        device=self.b0.device)
        return (z, z, z, z)

    def __call__(self, state, x: torch.Tensor):
        """x [C, B] float32 -> the section's output, same shape.  A CUDA
        tensor launches the kernel (:func:`biquad_df1`), a CPU tensor runs
        :meth:`plain`; any other device raises."""
        if x.device.type == "cpu":
            check(self, state, x)
            return self.plain(state, x)
        return biquad_df1(self, state, x)

    def coefs(self) -> tuple:
        """(b0, b1, b2, a1, a2), the order the kernel takes them in."""
        return self.b0, self.b1, self.b2, self.a1, self.a2

    def plain(self, state, x: torch.Tensor):
        """The block as torch ops on any device: the feedforward sum and
        the log-step scan of the feedback pair, in float64."""
        x1, x2, y1, y2 = state
        B = x.shape[-1]
        xm1 = torch.cat([x1[:, None], x[:, :-1]], dim=-1)
        xm2 = torch.cat([x2[:, None], xm1[:, :-1]], dim=-1)
        b0, b1, b2, a1, a2 = (c.double() for c in self.coefs())
        f = b0 * x.double() + b1 * xm1.double() + b2 * xm2.double()
        one, zero = torch.ones_like(a1), torch.zeros_like(a1)
        A = torch.stack([torch.stack([-a1, -a2]),
                         torch.stack([one, zero])]).expand(B, 2, 2)
        bv = torch.stack([f, torch.zeros_like(f)], dim=-1)   # [C, B, 2]
        s = 1
        while s < B:
            bv = torch.cat([bv[:, :s], torch.einsum(
                "bij,cbj->cbi", A[s:], bv[:, :-s]) + bv[:, s:]], dim=1)
            A = torch.cat([A[:s], torch.matmul(A[s:], A[:-s])], dim=0)
            s *= 2
        s0 = torch.stack([y1, y2], dim=-1).double()          # [C, 2]
        y = (torch.einsum("bij,cj->cbi", A, s0) + bv)[..., 0].float()
        y2n = torch.cat([y1[:, None], y[:, -2:]], dim=-1)[:, -2]
        return (x[:, -1], xm1[:, -1], y[:, -1], y2n), y


_ERR_BAD_SHAPE = -1                          # the launcher's error code


def check(op: Biquad, state, x: torch.Tensor) -> tuple[int, int]:
    """What both routes of :class:`Biquad` check first: ``x`` [C, B]
    float32 (C, B >= 1) with contiguous samples (any row stride), the
    state's four [C] float32 tensors and the five 0-dim float32
    coefficients, all on ``x``'s device.  Returns (C, B)."""
    if x.dtype != torch.float32:
        raise TypeError(f"samples must be torch.float32, got {x.dtype}")
    if x.dim() != 2 or x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"samples must be [C, B] with C, B >= 1, got "
                         f"{tuple(x.shape)}")
    C, B = x.shape
    if B > 1 and x.stride(1) != 1:
        raise ValueError("samples must be contiguous along the block")
    if len(state) != 4:
        raise ValueError(f"state must be (x1, x2, y1, y2), got "
                         f"{len(state)} tensors")
    for name, t in zip(("x1", "x2", "y1", "y2"), state):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be torch.float32, got {t.dtype}")
        if tuple(t.shape) != (C,) or t.device != x.device:
            raise ValueError(f"{name} must be {(C,)} on {x.device}, got "
                             f"{tuple(t.shape)} on {t.device}")
    _kernels.check_tensors(x, {
        name: (c, torch.float32, ())
        for name, c in zip(("b0", "b1", "b2", "a1", "a2"), op.coefs())})
    return C, B


@functools.cache
def _launcher():
    fn = _kernels.load("biquad").biquad_df1
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn.argtypes = [ptr, i64] + [ptr, i64] * 4 + [ptr] * 7 + [i32, i32, ptr]
    fn.restype = ctypes.c_int
    return fn


def biquad_df1(op: Biquad, state, x: torch.Tensor):
    """``op``'s block on ``x``'s CUDA device in one kernel launch
    (``biquad_df1.launches``): ((x1', x2', y1', y2'), y) as
    :meth:`Biquad.plain`.  The coefficients are read on the card, so
    nothing waits on it."""
    if x.device.type != "cuda":
        raise ValueError(f"biquad_df1: no kernel for device {x.device}")
    C, B = check(op, state, x)
    y = torch.empty((C, B), dtype=torch.float32, device=x.device)
    st = torch.empty((4, C), dtype=torch.float32, device=x.device)
    err = _kernels.call(
        x, _launcher(), x.data_ptr(), x.stride(0) if C > 1 else B,
        *(v for t in state for v in (t.data_ptr(), t.stride(0))),
        *(c.data_ptr() for c in op.coefs()), y.data_ptr(), st.data_ptr(),
        C, B)
    if err == _ERR_BAD_SHAPE:
        raise ValueError(f"biquad_df1: shape {(C, B)} outside the kernel's "
                         f"limits")
    if err != 0:
        raise RuntimeError(f"biquad_df1 launch failed: CUDA error {err}")
    biquad_df1.launches += 1
    return tuple(st.unbind(0)), y


biquad_df1.launches = 0


@dataclasses.dataclass(frozen=True)
class Preemphasis:
    """First-difference pre-emphasis y[n] = x[n] - c*x[n-1] (~6 dB/octave,
    microphone.c:452-465).  ``c`` is 0-dim or [C] per channel; c = 0 is an
    exact pass-through.  State is x_prev [C]."""

    c: torch.Tensor

    @classmethod
    def create(cls, c=0.97, device=None):
        return cls(c=torch.as_tensor(np.array(c, np.float32),
                                     device=resolve_device(device)))

    def init_state(self, channels: int) -> torch.Tensor:
        return torch.zeros((channels,), dtype=torch.float32,
                           device=self.c.device)

    def __call__(self, x_prev: torch.Tensor, x: torch.Tensor):
        xm1 = torch.cat([x_prev[:, None], x[:, :-1]], dim=-1)
        c = self.c if self.c.ndim == 0 else self.c[:, None]
        return x[:, -1], x - c * xm1


@dataclasses.dataclass(frozen=True)
class PhaseRotator:
    """Cascaded first-order allpass phase rotator (wdsp/iir.c:557-640):
    ``nstages`` sections y[n] = b0*x[n] + x[n-1] - b0*y[n-1] with
    b0 = (g-1)/(g+1), g = tan(pi*fc/fs) (TXA default fc = 338 Hz, 8
    stages) on the real mic audio, to disperse speech phase and lower the
    peak-to-average ratio before clipping.  Each section is the recurrence
    y[n] = (-b0)*y[n-1] + w[n], w[n] = b0*x[n] + x[n-1], run by one
    :class:`FirstOrder` built when the op is made.

    State: (x1, y1) each [nstages, C], the per-stage trailing samples."""

    b0: torch.Tensor
    nstages: int

    def __post_init__(self):
        object.__setattr__(self, "k", FirstOrder.create(-self.b0, 1.0,
                                                        self.b0))

    @classmethod
    def create(cls, fc_hz: float = 338.0, fs: float = 48000.0,
               nstages: int = 8, device=None):
        g = float(np.tan(np.pi * fc_hz / fs))
        return cls(b0=torch.tensor(np.float32((g - 1.0) / (g + 1.0)),
                                   device=resolve_device(device)),
                   nstages=int(nstages))

    def init_state(self, channels: int):
        z = torch.zeros((self.nstages, channels), dtype=torch.float32,
                        device=self.b0.device)
        return z, z

    def __call__(self, state, x: torch.Tensor):
        x1, y1 = state
        nx1, ny1 = [], []
        for n in range(self.nstages):
            w = self.b0 * x + torch.cat([x1[n][:, None], x[:, :-1]], dim=-1)
            y = self.k(w, y1[n])
            nx1.append(x[:, -1])
            ny1.append(y[:, -1])
            x = y
        return (torch.stack(nx1), torch.stack(ny1)), x
