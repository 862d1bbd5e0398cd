"""The transmitters' mic audio, made on the card from the seed: the ring of
``blocks`` consecutive blocks [C, audio_block] float32 at the audio rate.

- Voice rows (every mode but the digital ones): white noise band-limited
  to 300-2700 Hz (the bins outside zeroed over the whole ring, so the
  ring wraps without a seam), each row scaled to unit rms and then to a
  level drawn from the seed over the configuration's ``voice_rms_db``
  range (dB of full scale), then clipped at full scale as the mic's
  converter clips it (4.6% of the samples of a row at -6 dBFS rms);
- DGT_U rows: FT8's unshaped 8-FSK, a constant-amplitude tone stepping
  among 8 frequencies ``fsk_step_hz`` apart from ``fsk_base_hz`` every
  ``fsk_symbol`` samples, phase-continuous, the ring's wrap included, at
  an amplitude drawn over ``dgt_amp_db``.

The levels and the symbols come from a NumPy generator on the seed, every
noise sample from a ``torch.Generator`` on the device, in one call.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch

from qref.spec import rx_modes

TWO_PI = 2.0 * np.pi
DIGITAL = ("DGT_U",)


def levels(cfg: dict, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """(digital [C] bool, amplitude [C] float64): which rows carry the
    8-FSK tone, and each row's level (rms of the voice noise, peak of the
    tone)."""
    sig = cfg["signal"]
    modes = rx_modes(cfg)
    digital = np.array([m in DIGITAL for m in modes])
    rng = np.random.default_rng([seed, 2])
    voice = 10.0 ** (rng.uniform(*sig["voice_rms_db"], digital.size) / 20.0)
    tone = 10.0 ** (rng.uniform(*sig["dgt_amp_db"], digital.size) / 20.0)
    return digital, np.where(digital, tone, voice)


def symbols(cfg: dict, seed: int, N: int) -> np.ndarray:
    """[C, ceil(N / symbol)] int64 in 0..7: each row's 8-FSK symbols over
    ``N`` samples, drawn from the seed, the last two chosen so that the
    tone's phase over the N samples is a whole number of turns: the ring
    then wraps with no jump of phase."""
    sig = cfg["signal"]
    C = cfg["chain"]["channels"]
    fs = float(cfg["chain"].get("audio_rate", 48000.0))
    S = sig["fsk_symbol"]
    sym = np.random.default_rng([seed, 6]).integers(0, 8, (C, -(-N // S)))
    lengths = np.minimum(S, N - S * np.arange(sym.shape[1]))
    # turns of symbol i: (base + step s) n_i / fs; the last symbol keeps
    # tone 0, the one before it makes up the sum of the steps' turns
    turns = Fraction(sig["fsk_step_hz"]) / Fraction(fs)
    base = Fraction(sig["fsk_base_hz"]) * N / Fraction(fs)
    sym[:, -1] = 0
    if base.denominator != 1:
        raise ValueError("the 8-FSK tone cannot wrap without a jump")
    for row in sym if sym.shape[1] > 1 else ():
        done = sum(int(v) * int(n) for v, n in zip(row[:-2], lengths[:-2]))
        for v in sorted(range(8), key=lambda v: (v - row[-2]) % 8):
            if ((done + v * int(lengths[-2])) * turns).denominator == 1:
                row[-2] = v
                break
        else:
            raise ValueError("the 8-FSK tone cannot wrap without a jump")
    return sym


def mic_ring(cfg: dict, seed: int, blocks: int, device,
             gen: torch.Generator) -> list[torch.Tensor]:
    """``blocks`` consecutive blocks [C, audio_block] float32."""
    sig = cfg["signal"]
    ch = cfg["chain"]
    C, B = ch["channels"], ch.get("audio_block", 2048)
    fs = float(ch.get("audio_rate", 48000.0))
    N = blocks * B
    digital, level = levels(cfg, seed)
    noise = torch.randn((C, N), generator=gen, device=device)
    spec = torch.fft.rfft(noise)
    f = torch.fft.rfftfreq(N, 1.0 / fs).to(device)
    lo, hi = sig["voice_band_hz"]
    spec *= ((f >= lo) & (f <= hi)).to(spec.dtype)
    voice = torch.fft.irfft(spec, N)
    del noise, spec
    voice /= voice.square().mean(-1, keepdim=True).sqrt()
    # the 8-FSK tone on the digital rows: the phase is the running sum of
    # each sample's step
    S = sig["fsk_symbol"]
    dig = torch.as_tensor(np.flatnonzero(digital), device=device)
    sym = torch.as_tensor(symbols(cfg, seed, N)[digital], device=device)
    step = (TWO_PI / fs) * (sig["fsk_base_hz"] + sig["fsk_step_hz"] * sym)
    step = torch.repeat_interleave(step, S, dim=1)[:, :N]
    tone = torch.sin(torch.cumsum(step, dim=1)).to(torch.float32)
    del step
    x = voice.index_copy_(0, dig, tone)
    x *= torch.as_tensor(level, dtype=torch.float32, device=device)[:, None]
    x.clamp_(-1.0, 1.0)            # the mic ADC's full scale
    del tone
    return [x[:, j * B:(j + 1) * B].contiguous() for j in range(blocks)]
