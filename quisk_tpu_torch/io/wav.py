"""WAV I/O for IQ captures and audio.

Parity: the reference records/replays raw IQ through ``QuiskWav``
(quisk.c:292-577) and can run its whole RX chain from a recorded file with
no hardware (``FILE_PLAY_SAMPLES``, sound.c:987) — the replay path this
framework's file ingest mirrors.  IQ convention: 2-channel WAV, ch0 = I,
ch1 = Q; int16, int32 or float32 samples.
"""

from __future__ import annotations

import wave

import numpy as np


def read_iq_wav(path: str) -> tuple[np.ndarray, float]:
    """Read a 2-channel IQ WAV -> (complex128 [N], sample_rate)."""
    with wave.open(path, "rb") as w:
        nch = w.getnchannels()
        width = w.getsampwidth()
        rate = float(w.getframerate())
        raw = w.readframes(w.getnframes())
    if width == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float64) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float64) / 2147483648.0
    else:
        raise ValueError(f"unsupported sample width {width}")
    data = data.reshape(-1, nch)
    if nch == 2:
        return data[:, 0] + 1j * data[:, 1], rate
    if nch == 1:
        return data[:, 0].astype(np.complex128), rate
    raise ValueError(f"need 1 or 2 channels, got {nch}")


def write_iq_wav(path: str, iq: np.ndarray, sample_rate: float,
                 width: int = 2) -> None:
    iq = np.asarray(iq)
    scale = 32767.0 if width == 2 else 2147483647.0
    dt = "<i2" if width == 2 else "<i4"
    inter = np.empty((len(iq), 2), dtype=np.float64)
    inter[:, 0] = np.clip(iq.real, -1, 1) * scale
    inter[:, 1] = np.clip(iq.imag, -1, 1) * scale
    with wave.open(path, "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(width)
        w.setframerate(int(round(sample_rate)))
        w.writeframes(inter.astype(dt).tobytes())


def read_audio_wav(path: str) -> tuple[np.ndarray, float]:
    """Mono (or first-channel) audio WAV -> (float64 [N], rate)."""
    with wave.open(path, "rb") as w:
        nch, width, rate = w.getnchannels(), w.getsampwidth(), w.getframerate()
        raw = w.readframes(w.getnframes())
    if width == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float64) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float64) / 2147483648.0
    else:
        raise ValueError(f"unsupported sample width {width}")
    return data.reshape(-1, nch)[:, 0], float(rate)


def write_audio_wav(path: str, audio: np.ndarray, sample_rate: float) -> None:
    a = np.clip(np.asarray(audio), -1.0, 1.0)
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(int(round(sample_rate)))
        w.writeframes((a * 32767.0).astype("<i2").tobytes())
