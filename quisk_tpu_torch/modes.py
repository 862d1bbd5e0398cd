"""Demodulation/modulation mode identifiers.

Mirrors the mode set of the reference (quisk.h:55-70 defines CWL, CWU, LSB,
USB, AM, FM, EXT, DGT-U/L/IQ/FDV, IMD, FDV-U/L) so a user of the reference
finds the same vocabulary here.  Values are stable small ints so a
``[channels]`` int32 array of modes can drive branch-free batched demod
selection on the GPU.
"""

from __future__ import annotations

import enum


class Mode(enum.IntEnum):
    """Receive/transmit mode."""

    CWL = 0      # CW, lower sideband (narrow analytic filter below carrier)
    CWU = 1      # CW, upper sideband
    LSB = 2      # lower-sideband SSB
    USB = 3      # upper-sideband SSB
    AM = 4       # envelope AM
    FM = 5       # narrow FM (phase-difference discriminator)
    DGT_U = 6    # digital, USB-style wide filter
    DGT_L = 7    # digital, LSB-style wide filter
    DGT_IQ = 8   # digital, raw IQ pass-through
    DGT_FDV = 9  # digital voice (treated as DGT_U filterwise)
    FDV_U = 10
    FDV_L = 11
    IMD = 12     # two-tone TX test mode
    EXT = 13     # external/custom demodulator plugin slot

    @property
    def is_ssb_like(self) -> bool:
        return self in (Mode.CWL, Mode.CWU, Mode.LSB, Mode.USB,
                        Mode.DGT_U, Mode.DGT_L, Mode.DGT_FDV,
                        Mode.FDV_U, Mode.FDV_L)

    @property
    def is_lower(self) -> bool:
        """True when the passband sits below the carrier."""
        return self in (Mode.CWL, Mode.LSB, Mode.DGT_L, Mode.FDV_L)


# Default audio filter bandwidths per mode, Hz (the reference offers a row of
# bandwidth buttons per mode; quisk_conf_defaults.py FilterBw*).
DEFAULT_BANDWIDTH = {
    Mode.CWL: 500.0,
    Mode.CWU: 500.0,
    Mode.LSB: 2800.0,
    Mode.USB: 2800.0,
    Mode.AM: 6000.0,
    Mode.FM: 12500.0,   # NFM channel; pairs with 2.5 kHz deviation (Carson)
    Mode.DGT_U: 3000.0,
    Mode.DGT_L: 3000.0,
    Mode.DGT_IQ: 10000.0,
    Mode.DGT_FDV: 3000.0,
    Mode.FDV_U: 3000.0,
    Mode.FDV_L: 3000.0,
    Mode.IMD: 2800.0,
    Mode.EXT: 10000.0,
}

# CW audio pitch offset, Hz (reference centers CW filters about the pitch).
CW_PITCH = 600.0
