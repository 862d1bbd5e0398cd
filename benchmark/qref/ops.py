"""The reference's elementwise stages in float64 torch, on any device:
one-pole recurrences, the demodulators and the sliding maximum.

A one-pole ``y[n] = a y[n-1] + b x[n]`` from rest is the convolution of
``x`` with ``b a^n``; the impulse response is cut where what it leaves
out is under 1e-18 of the input's largest magnitude
(``a^L / (1 - a) < 1e-18``), and the convolution taken by FFT."""

from __future__ import annotations

import math

import torch

from qref.design import next_pow2


def one_pole(x: torch.Tensor, a: float, b: float) -> torch.Tensor:
    """y[n] = a y[n-1] + b x[n] along the last axis, from y[-1] = 0."""
    N = x.shape[-1]
    L = min(N, math.ceil(math.log(1e-18 * (1.0 - a)) / math.log(a)))
    h = b * a ** torch.arange(L, dtype=torch.float64, device=x.device)
    n = next_pow2(N + L - 1)
    y = torch.fft.irfft(torch.fft.rfft(x, n) * torch.fft.rfft(h, n), n)
    return y[..., :N]


def before(x: torch.Tensor) -> torch.Tensor:
    """x delayed one sample along the last axis, from rest."""
    return torch.nn.functional.pad(x, (1, 0))[..., :-1]


def am(z: torch.Tensor, pole: float, gain: float) -> torch.Tensor:
    """gain times the DC-blocked envelope: y[n] = e[n] - e[n-1] + p y[n-1]."""
    env = z.abs()
    return gain * one_pole(env - before(env), pole, 1.0)


def fm(z: torch.Tensor, gain: float, de_a: float) -> torch.Tensor:
    """The phase-difference discriminator (0 where |z[n] conj z[n-1]| is
    1e-12 or less) times ``gain``, through the de-emphasis one-pole."""
    d = z * before(z).conj()
    disc = torch.where(d.abs() > 1e-12, torch.angle(d),
                       torch.zeros((), dtype=torch.float64, device=z.device))
    return one_pole(disc * gain, de_a, 1.0 - de_a)


def demod(z: torch.Tensor, family, fm_gain: float, de_a: float,
          dc_a: float) -> torch.Tensor:
    """Rows of z [n, N] complex128 demodulated by their family ("ssb",
    "am", "fm"): SSB 2 Re z, AM and FM as above with gain 2 and
    ``fm_gain``."""
    out = 2.0 * z.real
    for fam, f in (("am", lambda u: am(u, dc_a, 2.0)),
                   ("fm", lambda u: fm(u, fm_gain, de_a))):
        rows = [i for i, v in enumerate(family) if v == fam]
        if rows:
            idx = torch.as_tensor(rows, device=z.device)
            out[idx] = f(z[idx])
    return out


def window_max(x: torch.Tensor, W: int) -> torch.Tensor:
    """max(x[..., n : n + W]) for every n, the window cut at the end."""
    xp = torch.nn.functional.pad(x, (0, W - 1), value=-math.inf)
    return xp.unfold(-1, W, 1).amax(-1)
