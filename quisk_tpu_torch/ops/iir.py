"""First- and second-order IIR sections as parallel recurrences.

One-pole filters sit in the demod chain: AM DC removal (quisk.c:2002-2025)
and FM de-emphasis (quisk.c:2057-2064).  ``y[n] = a*y[n-1] + b*x[n]`` is
a composition of affine maps, evaluated over the block axis in log-depth
(Hillis-Steele doubling), vectorised over channels; the carried state is
the last output sample.  Long blocks (B >= 2048, B % 128 == 0, scalar
``a``) take the chunked form of ``quisk_tpu.ops.iir``: a [128, 128]
lower-triangular decay matmul within chunks plus a short scan over chunk
carries, so the sums group as the reference's do; ``apply_tm`` is the same with
time on axis -2 and channels last.  :class:`Biquad` runs
the same log-step scan over 2x2 affine maps, in float64.  The TX path's
:class:`Preemphasis` is a first difference and :class:`PhaseRotator` a
cascade of first-order allpass sections on the same scan.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

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


def first_order_scan(x: torch.Tensor, a, b, y_prev: torch.Tensor):
    """All outputs of y[n] = a*y[n-1] + b*x[n] given y[-1] = y_prev.

    x [C, B]; a, b scalar (0-dim tensor or float) or [C, 1]; y_prev [C].
    """
    a_t = torch.as_tensor(a, dtype=x.dtype, device=x.device)
    B = x.shape[-1]
    if a_t.ndim == 0 and B >= 2048 and B % 128 == 0:
        return _first_order_chunked(x, a_t, b, y_prev)
    A = torch.broadcast_to(a_t, x.shape)
    Bv = torch.as_tensor(b, dtype=x.dtype, device=x.device) * x
    A_cum, B_cum = affine_scan(A, Bv)
    return B_cum + A_cum * y_prev[:, None]


def _first_order_chunked(x: torch.Tensor, a: torch.Tensor, b,
                         y_prev: torch.Tensor, L: int = 128) -> torch.Tensor:
    """Chunked y[n] = a*y[n-1] + b*x[n] (scalar a).

    Within chunk j (start carry c_j): y[n] = a^(n+1) c_j + sum_k a^(n-k)
    u[k], the sum an fp32 matmul with T[n, k] = a^(n-k); the carries follow
    c_{j+1} = a^L c_j + e_j, a (B/L)-long affine scan.  Powers are built as
    |a|^d * sign(a)^d, since a float power of a negative base is NaN.
    """
    C, B = x.shape
    nch = B // L
    dt, dev = x.dtype, x.device
    u = (torch.as_tensor(b, dtype=dt, device=dev) * x).reshape(C, nch, L)
    n = torch.arange(L, device=dev)
    d = n[:, None] - n[None, :]
    dm = torch.clamp(d, min=0).to(dt)
    one = torch.ones((), dtype=dt, device=dev)
    sgn = torch.where(a < 0, -one, one)
    mag = torch.abs(a)
    pw = (mag ** dm) * torch.where(dm % 2 == 0, one, sgn)
    T = torch.where(d >= 0, pw, torch.zeros((), dtype=dt, device=dev))
    yin = torch.matmul(u, T.T)                              # [C, nch, L]
    e = yin[:, :, -1]
    aL = (mag ** L) * (sgn ** (L % 2) if L % 2 else 1.0)
    Aj = torch.broadcast_to(aL, (C, nch))
    Acum, Ecum = affine_scan(Aj, e)
    s = Ecum + Acum * y_prev[:, None]                        # chunk end states
    c = torch.cat([y_prev[:, None], s[:, :-1]], dim=-1)
    n1 = (n + 1).to(dt)
    decay = (mag ** n1) * torch.where((n + 1) % 2 == 0, one, sgn)
    y = yin + c[:, :, None] * decay[None, None, :]
    return y.reshape(C, B)


def first_order_scan_tm(x: torch.Tensor, a, b, y_prev: torch.Tensor):
    """Time-major twin of :func:`first_order_scan`: x [..., T, C] with time
    on axis -2 and channels last (the layout the PFB's cross-branch IDFT
    produces), a, b scalar, y_prev [..., C].  Long blocks (T >= 2048,
    T % 128 == 0, scalar ``a``) take the chunked triangular matmul, the
    rest the log-step scan, as ``quisk_tpu.ops.iir._first_order_scan_tm``
    chooses."""
    a_t = torch.as_tensor(a, dtype=x.dtype, device=x.device)
    T = x.shape[-2]
    if a_t.ndim == 0 and T >= 2048 and T % 128 == 0:
        return _first_order_chunked_tm(x, a_t, b, y_prev)
    A = torch.broadcast_to(a_t, x.shape)
    Bv = torch.as_tensor(b, dtype=x.dtype, device=x.device) * x
    A_cum, B_cum = affine_scan(A, Bv, dim=-2)
    return B_cum + A_cum * y_prev[..., None, :]


def _first_order_chunked_tm(x: torch.Tensor, a: torch.Tensor, b,
                            y_prev: torch.Tensor, L: int = 128):
    """Chunked y[n] = a*y[n-1] + b*x[n] over axis -2: the factorisation of
    :func:`_first_order_chunked` with each chunk an fp32 [L, L] x [L, C]
    matmul, channels last."""
    T, C = x.shape[-2:]
    lead = x.shape[:-2]
    nch = T // L
    dt, dev = x.dtype, x.device
    u = (torch.as_tensor(b, dtype=dt, device=dev) * x).reshape(
        *lead, nch, L, C)
    n = torch.arange(L, device=dev)
    d = n[:, None] - n[None, :]
    dm = torch.clamp(d, min=0).to(dt)
    one = torch.ones((), dtype=dt, device=dev)
    sgn = torch.where(a < 0, -one, one)
    mag = torch.abs(a)
    pw = (mag ** dm) * torch.where(dm % 2 == 0, one, sgn)
    Tm = torch.where(d >= 0, pw, torch.zeros((), dtype=dt, device=dev))
    yin = torch.matmul(Tm, u)                               # [.., nch, L, C]
    e = yin[..., :, -1, :]                                  # [.., nch, C]
    aL = (mag ** L) * (sgn ** (L % 2) if L % 2 else 1.0)
    Aj = torch.broadcast_to(aL, e.shape)
    Acum, Ecum = affine_scan(Aj, e, dim=-2)
    s = Ecum + Acum * y_prev[..., None, :]                  # chunk end states
    c = torch.cat([y_prev[..., None, :], s[..., :-1, :]], dim=-2)
    n1 = (n + 1).to(dt)
    decay = (mag ** n1) * torch.where((n + 1) % 2 == 0, one, sgn)   # [L]
    y = yin + c[..., :, None, :] * decay[:, None]
    return y.reshape(*lead, T, C)


@dataclasses.dataclass(frozen=True)
class OnePole:
    """y[n] = a*y[n-1] + b*x[n].  Lowpass: a = exp(-2 pi fc / fs), b = 1-a."""

    a: torch.Tensor
    b: torch.Tensor

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
        y = first_order_scan(x, self.a, self.b, y_prev)
        return y[:, -1], y

    def apply_tm(self, y_prev: torch.Tensor, x: torch.Tensor):
        """Time-major form: x [..., T, C], y_prev [..., C]."""
        y = first_order_scan_tm(x, self.a, self.b, y_prev)
        return y[..., -1, :], y


@dataclasses.dataclass(frozen=True)
class DCBlock:
    """DC blocker y[n] = x[n] - x[n-1] + a*y[n-1] (Lyons; the reference's
    AM path).  State is (x_prev [C], y_prev [C])."""

    a: torch.Tensor

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
        y = first_order_scan(d, self.a, 1.0, y_prev)
        return (x[:, -1], y[:, -1]), y

    def apply_tm(self, state, x: torch.Tensor):
        """Time-major form: x [..., T, C], the state pair [..., C] each."""
        x_prev, y_prev = state
        d = x - torch.cat([x_prev[..., None, :], x[..., :-1, :]], dim=-2)
        y = first_order_scan_tm(d, self.a, 1.0, y_prev)
        return (x[..., -1, :], y[..., -1, :]), y


def _rbj(b0, b1, b2, a1, a2, a0, device) -> "Biquad":
    return Biquad(*(torch.tensor(np.float32(v / a0), device=device)
                    for v in (b0, b1, b2, a1, a2)))


@dataclasses.dataclass(frozen=True)
class Biquad:
    """Second-order IIR section (direct form I) as a parallel recurrence
    (wdsp/iir.c snotch / speak / mpeak).  The feedback pair
    (y[n-1], y[n-2]) evolves linearly, s[n] = A s[n-1] + [f[n], 0], so the
    block is a log-step scan over 2x2 affine maps.  A is the same at every
    step: its running products A^(n+1) are scanned once per block as
    [B, 2, 2] and shared by all channels.

    The feedforward sum and the scan are carried in float64 and the output
    rounded to float32: in float32 the zeros' cancellation and the matrix
    powers of a pole pair near the unit circle lose every digit (the CTCSS notch, 100 Hz at q=5 and 48 kS/s, came out ~1 dB
    from the float64 recurrence on noise; the JAX op's float32 scan, in
    another tree order, ~26 dB).

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
        x1, x2, y1, y2 = state
        B = x.shape[-1]
        xm1 = torch.cat([x1[:, None], x[:, :-1]], dim=-1)
        xm2 = torch.cat([x2[:, None], x1[:, None], x[:, :-2]], dim=-1)
        b0, b1, b2, a1, a2 = (c.double() for c in (self.b0, self.b1, self.b2,
                                                   self.a1, self.a2))
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
        return (x[:, -1], x[:, -2], y[:, -1], y[:, -2]), y


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
    y[n] = (-b0)*y[n-1] + w[n], w[n] = b0*x[n] + x[n-1], run by
    :func:`first_order_scan`.

    State: (x1, y1) each [nstages, C], the per-stage trailing samples."""

    b0: torch.Tensor
    nstages: int

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
            y = first_order_scan(w, -self.b0, 1.0, y1[n])
            nx1.append(x[:, -1])
            ny1.append(y[:, -1])
            x = y
        return (torch.stack(nx1), torch.stack(ny1)), x
