"""The captures the benchmark feeds the receivers, made on the card from
the seed: complex noise and one modulated station a listened channel.

Per-channel parameters (level, SSB tone) come from a NumPy generator on
the seed; every sample comes from a ``torch.Generator`` on the device, in
a few large calls.  Station families: USB / LSB a tone ``f_a`` above /
below the carrier, AM a carrier at ``am_depth`` by an ``am_tone_hz``
tone, FM a carrier swung by ``fm_deviation_hz`` at ``fm_tone_hz``.
"""

from __future__ import annotations

import numpy as np
import torch

from qref.spec import listened, pfb_modes, rx_modes, rx_tunes

TWO_PI = 2.0 * np.pi


def _draws(sig: dict, modes: list[str], seed: int):
    rng = np.random.default_rng([seed, 2])
    n = len(modes)
    level = 10.0 ** (rng.uniform(*sig["level_db"], n) / 20.0)
    f_a = rng.uniform(*sig["ssb_tone_hz"], n)
    return level, f_a


def _baseband(mode_id: torch.Tensor, level, f_a, t, sig: dict):
    """Stations' complex envelopes at times ``t`` [..., N] (seconds) for
    rows of modes ``mode_id`` (0 USB, 1 LSB, 2 AM, 3 FM), float64."""
    ssb = torch.polar(level, TWO_PI * f_a * t * (1 - 2 * (mode_id == 1)))
    am_env = level * (1.0 + sig["am_depth"]
                      * torch.cos(TWO_PI * sig["am_tone_hz"] * t))
    beta = sig["fm_deviation_hz"] / sig["fm_tone_hz"]
    fm = torch.polar(level, beta * torch.sin(TWO_PI * sig["fm_tone_hz"] * t))
    return torch.where(mode_id == 3, fm, torch.where(
        mode_id == 2, am_env.to(fm.dtype), ssb))


_IDS = {"USB": 0, "LSB": 1, "AM": 2, "FM": 3}


def rx_ring(cfg: dict, seed: int, blocks: int, block_in: int, device,
            gen: torch.Generator) -> list[torch.Tensor]:
    """``blocks`` consecutive blocks [C, block_in] complex64: each row its
    own capture, the station on the row's dial."""
    sig = cfg["signal"]
    modes = rx_modes(cfg)
    C = len(modes)
    fs = float(cfg["chain"]["sample_rate"])
    level, f_a = _draws(sig, modes, seed)
    col = {"dtype": torch.float64, "device": device}
    lv = torch.as_tensor(level, **col)[:, None]
    fa = torch.as_tensor(f_a, **col)[:, None]
    tune = torch.as_tensor(rx_tunes(cfg), **col)[:, None]
    mid = torch.as_tensor([_IDS[m] for m in modes], device=device)[:, None]
    out = []
    for j in range(blocks):
        s = torch.arange(j * block_in, (j + 1) * block_in, **col)[None, :]
        t = s / fs
        st = _baseband(mid, lv, fa, t, sig) * torch.polar(
            torch.ones_like(t), TWO_PI * tune * t)
        x = torch.randn((C, block_in, 2), generator=gen, device=device)
        x = torch.view_as_complex(x).mul_(sig["noise_rms"])
        out.append(x.add_(st.to(torch.complex64)))
        del st, s, t
    return out


def pfb_ring(cfg: dict, seed: int, blocks: int, device,
             gen: torch.Generator) -> list[torch.Tensor]:
    """``blocks`` consecutive blocks [1, B] complex64 of one wideband
    capture: noise and a station centred on each listened channel.  The
    stations are made a frame of K samples at a time, by one inverse DFT
    of their envelopes over the K channel bins, the envelope interpolated
    linearly across each frame (channel c sits at c/K of the input rate,
    so its carrier repeats every frame)."""
    sig = cfg["signal"]
    p = cfg["pipeline"]
    K, B = p["n_chan"], p["block"]
    rate = float(cfg["input_rate"])
    modes = pfb_modes(cfg)
    lis = listened(cfg, seed)
    level, f_a = _draws(sig, [modes[c] for c in lis], seed)
    col = {"dtype": torch.float64, "device": device}
    lv = torch.as_tensor(level, **col)[None, :]
    fa = torch.as_tensor(f_a, **col)[None, :]
    mid = torch.as_tensor([_IDS[modes[c]] for c in lis], device=device)[None]
    cols = torch.as_tensor(lis, device=device)
    F = B // K
    r = torch.arange(K, device=device, dtype=torch.float32) / K
    out = []
    for j in range(blocks):
        g = torch.arange(j * F, (j + 1) * F + 1, **col)[:, None]
        env = _baseband(mid, lv, fa, g * (K / rate), sig)
        S = torch.zeros((F + 1, K), dtype=torch.complex128, device=device)
        S[:, cols] = env
        Y = (torch.fft.ifft(S, dim=-1) * K).to(torch.complex64)
        st = Y[:-1] * (1.0 - r) + Y[1:] * r
        x = torch.randn((1, B, 2), generator=gen, device=device)
        x = torch.view_as_complex(x).mul_(sig["noise_rms"])
        out.append(x.add_(st.reshape(1, B)))
        del S, Y, st, env
    return out
