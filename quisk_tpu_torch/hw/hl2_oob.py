"""Hermes-Lite 2 out-of-band power-amplifier guard.

Parity: quisk_hardware_hl2_oob.py (63 LoC) — a Hermes subclass that
disables the HL2 power amplifier whenever the transmit frequency plus
the mode's occupied sidebands falls outside the selected band.  The
effective band is narrowed per mode (CW 40 Hz, SSB 3 kHz on the occupied
side, AM 3 kHz both, FM 8 kHz both), and HeartBeat toggles the PA enable
bit — register row 0x09, bit 19 — when the in-band status changes.
"""

from __future__ import annotations

from quisk_tpu_torch.hw.base import register_hardware
from quisk_tpu_torch.hw.hermes import HermesHardware

#: amateur band edges in Hz (quisk_conf_defaults.py:2553 BandEdge)
BAND_EDGE: dict[str, tuple[int, int]] = {
    "137k": (135_700, 137_800), "500k": (472_000, 479_000),
    "160": (1_800_000, 2_000_000), "80": (3_500_000, 4_000_000),
    "60": (5_300_000, 5_430_000), "40": (7_000_000, 7_300_000),
    "30": (10_100_000, 10_150_000), "20": (14_000_000, 14_350_000),
    "17": (18_068_000, 18_168_000), "15": (21_000_000, 21_450_000),
    "12": (24_890_000, 24_990_000), "10": (28_000_000, 29_700_000),
    "6": (50_000_000, 54_000_000), "4": (70_000_000, 70_500_000),
    "2": (144_000_000, 148_000_000), "1.25": (222_000_000, 225_000_000),
    "70cm": (420_000_000, 450_000_000), "33cm": (902_000_000, 928_000_000),
}

PA_ROW = 0x09
PA_BIT = 19


def mode_band_edges(band: str, mode: str) -> tuple[int, int]:
    """Band edges narrowed by the mode's occupied bandwidth
    (FixBandEdge parity)."""
    if band in ("Audio", "Time") or band not in BAND_EDGE:
        return 0, 0
    f1, f2 = BAND_EDGE[band]
    if mode in ("CWL", "CWU"):
        return f1 + 40, f2 - 40
    if mode in ("USB", "DGT-U", "FDV-U", "IMD"):
        return f1, f2 - 3000
    if mode in ("LSB", "DGT-L", "FDV-L"):
        return f1 + 3000, f2
    if mode == "AM":
        return f1 + 3000, f2 - 3000
    if mode in ("FM", "DGT-FM"):
        return f1 + 8000, f2 - 8000
    return f1 + 3000, f2 - 3000


@register_hardware("hl2_oob")
class HermesLite2OOBHardware(HermesHardware):
    """HL2 with automatic out-of-band PA disable."""

    def __init__(self, conf=None, transport=None,
                 power_amp_wanted: bool = True):
        super().__init__(conf, transport)
        self.power_amp_wanted = power_amp_wanted
        self.band_edge1 = 0
        self.band_edge2 = 0

    def ChangeMode(self, mode: str) -> None:
        super().ChangeMode(mode)
        self._fix_band_edge()

    def ChangeBand(self, band: str) -> None:
        super().ChangeBand(band)
        self._fix_band_edge()

    def _fix_band_edge(self) -> None:
        self.band_edge1, self.band_edge2 = \
            mode_band_edges(self.band, self.mode)

    def pa_enabled(self) -> bool:
        byte_index = 4 - PA_BIT // 8
        return bool(self.ctl.get_byte(PA_ROW, byte_index)
                    & (1 << (PA_BIT % 8)))

    def HeartBeat(self) -> None:
        super().HeartBeat()
        in_band = self.band_edge1 <= self.tx_frequency <= self.band_edge2
        want = in_band and self.power_amp_wanted
        if want != self.pa_enabled():
            self.ctl.set_bit(PA_ROW, PA_BIT, want)
