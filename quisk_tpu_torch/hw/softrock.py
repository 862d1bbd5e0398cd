"""Softrock (Si570) control plane.

Parity: softrock/hardware_usb.py — tunes a Softrock's Si570 programmable
oscillator over USB control transfers (pyusb).  The USB transport is
injectable (tests run without hardware); the Si570 register mathematics —
the actual logic — is implemented fully:

- output f = fxtal * RFREQ / (HS_DIV * N1), RFREQ a 38-bit fixed-point
  (2^28 fraction), HS_DIV in {4,5,6,7,9,11}, N1 in 1..128 (even or 1),
- DCO = f * HS_DIV * N1 must stay in [4.85, 5.67] GHz,
- registers 7..12 pack HS_DIV (3 bits), N1 (7 bits), RFREQ (38 bits).

The x4 quadrature-sampling factor (the Si570 runs at 4x the RX center,
softrock convention) lives in the Hardware wrapper.
"""

from __future__ import annotations

import numpy as np

from quisk_tpu_torch.hw.base import Hardware, register_hardware

DCO_MIN = 4.85e9
DCO_MAX = 5.67e9
HS_DIV_VALUES = (11, 9, 7, 6, 5, 4)
DEFAULT_FXTAL = 114.285e6        # nominal crystal


def si570_divider_plan(freq_hz: float) -> tuple[int, int]:
    """Choose (HS_DIV, N1) keeping the DCO in range, minimising DCO
    (lowest power, per the Si570 datasheet procedure)."""
    best = None
    for hs in HS_DIV_VALUES:
        n1_min = int(np.ceil(DCO_MIN / (freq_hz * hs)))
        n1_max = min(int(np.floor(DCO_MAX / (freq_hz * hs))), 128)
        for n1 in range(max(1, n1_min), n1_max + 1):
            if n1 != 1 and n1 % 2:
                n1 += 1                       # N1 must be 1 or even
                if n1 > n1_max:
                    break
            dco = freq_hz * hs * n1
            if DCO_MIN <= dco <= DCO_MAX and (best is None or dco < best[0]):
                best = (dco, hs, n1)
    if best is None:
        raise ValueError(f"{freq_hz/1e6:.3f} MHz not reachable by Si570")
    return best[1], best[2]


def si570_registers(freq_hz: float,
                    fxtal_hz: float = DEFAULT_FXTAL) -> bytes:
    """Registers 7..12 for the target output frequency."""
    hs, n1 = si570_divider_plan(freq_hz)
    rfreq = freq_hz * hs * n1 / fxtal_hz
    rf = int(round(rfreq * (1 << 28)))        # 38-bit fixed point
    r = bytearray(6)
    r[0] = ((hs - 4) << 5) | ((n1 - 1) >> 2)
    r[1] = (((n1 - 1) & 0x3) << 6) | ((rf >> 32) & 0x3F)
    r[2] = (rf >> 24) & 0xFF
    r[3] = (rf >> 16) & 0xFF
    r[4] = (rf >> 8) & 0xFF
    r[5] = rf & 0xFF
    return bytes(r)


def si570_decode(regs: bytes, fxtal_hz: float = DEFAULT_FXTAL) -> float:
    """Inverse of :func:`si570_registers` — the frequency the registers
    program (used to read back the startup frequency)."""
    hs = ((regs[0] >> 5) & 0x7) + 4
    n1 = (((regs[0] & 0x1F) << 2) | (regs[1] >> 6)) + 1
    rf = ((regs[1] & 0x3F) << 32) | (regs[2] << 24) | (regs[3] << 16) \
        | (regs[4] << 8) | regs[5]
    return fxtal_hz * (rf / (1 << 28)) / (hs * n1)


@register_hardware("softrock")
class SoftrockHardware(Hardware):
    """Softrock RX: VFO = 4x the center frequency (quadrature sampling
    clock); tuning writes Si570 registers through the injected USB
    transport (anything with ``write_registers(bytes)``)."""

    # soundcard TX centered on the Si570 VFO: the host rotates the
    # outgoing IQ to the TX offset (sound.c:708 tx_mic_phase path)
    tx_dds = False

    def __init__(self, conf=None, transport=None,
                 fxtal_hz: float = DEFAULT_FXTAL, multiplier: float = 4.0):
        super().__init__(conf)
        self.transport = transport
        self.fxtal = fxtal_hz
        self.multiplier = multiplier

    def open(self) -> str:
        self.status_text = "softrock (Si570)"
        return self.status_text

    def ChangeFrequency(self, tx_freq, vfo_freq, source="", band=""):
        regs = si570_registers(vfo_freq * self.multiplier, self.fxtal)
        if self.transport is not None:
            self.transport.write_registers(regs)
        return super().ChangeFrequency(tx_freq, vfo_freq, source, band)
