"""Signal generators (host-side, float64) for tests, benchmarks and TX tests.

Parity: the reference's built-in test tone (quisk.c:1258-1303 incl. AM/FM
modulated variants), two-tone IMD generator (microphone.c:140-159), and the
``Spot`` carrier — these are its de-facto fixtures (SURVEY.md §4).
"""

from __future__ import annotations

import numpy as np
from scipy import signal as _sig

TWO_PI = 2.0 * np.pi


def tone(freq_hz: float, fs: float, n: int, phase: float = 0.0,
         amplitude: float = 1.0) -> np.ndarray:
    """Complex exponential at freq_hz."""
    t = np.arange(n, dtype=np.float64) / fs
    return amplitude * np.exp(1j * (TWO_PI * freq_hz * t + phase))


def two_tone(f1: float, f2: float, fs: float, n: int,
             amplitude: float = 0.5) -> np.ndarray:
    return amplitude * (tone(f1, fs, n) + tone(f2, fs, n))


def voice_like(fs: float, n: int, seed: int = 0,
               band: tuple[float, float] = (300.0, 2700.0)) -> np.ndarray:
    """Band-limited noise standing in for speech (real, unit RMS)."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(n + 4096)
    sos = _sig.butter(6, band, btype="bandpass", fs=fs, output="sos")
    a = _sig.sosfilt(sos, w)[4096:]
    return a / np.sqrt(np.mean(a**2))


def ssb_signal(audio: np.ndarray, fs: float, carrier_hz: float = 0.0,
               lower: bool = False) -> np.ndarray:
    """Complex IQ of an SSB transmission of `audio` about carrier_hz.

    USB: IQ = analytic(audio) shifted to the carrier (spectrum occupies
    [carrier, carrier+B]); LSB mirrors below the carrier.
    """
    z = _sig.hilbert(np.asarray(audio, dtype=np.float64))
    if lower:
        z = np.conj(z)
    if carrier_hz != 0.0:
        z = z * tone(carrier_hz, fs, len(z))
    return z


def am_signal(audio: np.ndarray, fs: float, carrier_hz: float = 0.0,
              depth: float = 0.8) -> np.ndarray:
    env = 1.0 + depth * np.asarray(audio, dtype=np.float64)
    return env * tone(carrier_hz, fs, len(env))


def fm_signal(audio: np.ndarray, fs: float, deviation_hz: float = 5000.0,
              carrier_hz: float = 0.0) -> np.ndarray:
    phase = TWO_PI * deviation_hz * np.cumsum(audio) / fs
    z = np.exp(1j * phase)
    if carrier_hz != 0.0:
        z = z * tone(carrier_hz, fs, len(z))
    return z


def station_iq(mode, fs: float, n: int, carrier_hz: float = 0.0,
               seed: int = 0, fm_deviation_hz: float = 5000.0,
               cw_pitch: float = 0.0) -> np.ndarray:
    """Deterministic one-station IQ capture of the given Mode at carrier_hz.

    The per-mode modulated test signal the reference injects as its test
    tone (quisk.c:1258-1303 has plain/AM/FM variants); used by the sharded
    conformance tests so every channel of a mixed-mode batch receives a
    well-conditioned signal (FM demod of raw noise is chaotic in the
    discriminator's angle()).
    """
    from quisk_tpu_torch.modes import Mode

    m = Mode(int(mode))
    if m in (Mode.CWU, Mode.CWL):
        # keyed carrier on the dial (the RX RIT moves it to the pitch)
        key = (np.arange(n) // int(fs * 0.05)) % 2
        return (key * tone(carrier_hz + cw_pitch, fs, n)).astype(np.complex64)
    voice = voice_like(fs, n, seed=seed, band=(300.0, 2500.0))
    voice = voice / np.abs(voice).max()     # peak-normalize: keeps the FM
    if m == Mode.AM:                        # carrier inside the channel
        z = am_signal(voice, fs, carrier_hz, depth=0.6)
    elif m == Mode.FM:
        # Carson bandwidth (dev + f_max) must stay inside the RX channel
        # filter or the envelope collapses and the discriminator's angle
        # becomes chaotic; 0.6x deviation of a peak-1 voice is safely in
        z = fm_signal(0.6 * voice, fs, deviation_hz=fm_deviation_hz,
                      carrier_hz=carrier_hz)
    else:                       # SSB-ish (USB/LSB/DGT/FDV/EXT/IQ)
        z = ssb_signal(voice, fs, carrier_hz, lower=m.is_lower)
    return z.astype(np.complex64)


def awgn(x: np.ndarray, snr_db: float, seed: int = 1) -> np.ndarray:
    """Add complex white Gaussian noise at the given SNR."""
    rng = np.random.default_rng(seed)
    p_sig = np.mean(np.abs(x) ** 2)
    p_n = p_sig / 10 ** (snr_db / 10.0)
    if np.iscomplexobj(x):
        n = (rng.standard_normal(len(x)) + 1j * rng.standard_normal(len(x)))
        n *= np.sqrt(p_n / 2.0)
    else:
        n = rng.standard_normal(len(x)) * np.sqrt(p_n)
    return x + n
