"""The narrowband-FM receivers' captures, made on the card from the seed:
unit-rms complex noise on each rail, and on three channels in four a
repeater's FM carrier on the channel's dial, swung by a voice tone and the
repeater's sub-audible CTCSS tone; the fourth channel of each four is idle
(noise alone), so its squelch stays shut.

The stations' levels (in dB over the noise's rms on a rail) come from a
NumPy generator on the seed, every noise sample from a
``torch.Generator`` on the device, in one call a block.
"""

from __future__ import annotations

import numpy as np
import torch

from qref.spec import rx_tunes

TWO_PI = 2.0 * np.pi


def stations(cfg: dict, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """(on [C] bool, level [C] float64 amplitude): which channels carry a
    station, and its carrier's amplitude (0 where idle)."""
    sig = cfg["signal"]
    C = cfg["chain"]["channels"]
    on = np.arange(C) % sig["idle_every"] != sig["idle_every"] - 1
    rng = np.random.default_rng([seed, 2])
    level = 10.0 ** (rng.uniform(*sig["level_db"], C) / 20.0)
    return on, np.where(on, level, 0.0)


def pllnfm_ring(cfg: dict, seed: int, blocks: int, block_in: int, device,
                gen: torch.Generator) -> list[torch.Tensor]:
    """``blocks`` consecutive blocks [C, block_in] complex64, each row its
    own capture at the configuration's sample rate."""
    sig = cfg["signal"]
    fs = float(cfg["chain"]["sample_rate"])
    C = cfg["chain"]["channels"]
    _, level = stations(cfg, seed)
    col = {"dtype": torch.float64, "device": device}
    lv = torch.as_tensor(level, **col)[:, None]
    tune = torch.as_tensor(rx_tunes(cfg), **col)[:, None]
    b_voice = sig["voice_deviation_hz"] / sig["voice_hz"]
    b_tone = sig["ctcss_deviation_hz"] / sig["ctcss_hz"]
    out = []
    for j in range(blocks):
        t = torch.arange(j * block_in, (j + 1) * block_in, **col)[None, :] / fs
        mod = (b_voice * torch.sin(TWO_PI * sig["voice_hz"] * t)
               + b_tone * torch.sin(TWO_PI * sig["ctcss_hz"] * t))
        st = torch.polar(lv.expand(C, block_in), mod + TWO_PI * tune * t)
        x = torch.randn((C, block_in, 2), generator=gen, device=device)
        x = torch.view_as_complex(x).mul_(sig["noise_rms"])
        out.append(x.add_(st.to(torch.complex64)))
        del st, mod, t
    return out
