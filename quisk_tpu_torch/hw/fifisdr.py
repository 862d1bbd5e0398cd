"""FiFi-SDR control plane (Softrock derivative with vendor extras).

Parity: quisk_hardware_fifisdr.py (156 LoC) — a Softrock-compatible
radio with additional vendor requests on the same USB control endpoint:

- GET_FIFI_EXTRA = 0xAB with index selecting the item:
  0 = 4-byte LE SVN version, 1 = 20-byte NUL-terminated firmware string,
  19 = preamp state.
- SET_FIFI_EXTRA = 0xAC, index 19 = write preamp (0 = -6 dB, 1 = 0 dB).

The control transport is injectable: ``transfer_in(request, index,
length)`` / ``transfer_out(request, index, bytes)``.
"""

from __future__ import annotations

from quisk_tpu_torch.hw.base import register_hardware
from quisk_tpu_torch.hw.softrock import SoftrockHardware

GET_FIFI_EXTRA = 0xAB
SET_FIFI_EXTRA = 0xAC

EXTRA_READ_SVN_VERSION = 0
EXTRA_READ_FW_VERSION = 1
EXTRA_WRITE_PREAMP = 19
EXTRA_READ_PREAMP = 19

RF_GAIN_LABELS = ("-6 dB", "0 dB")


def decode_svn(raw: bytes) -> int:
    """4 little-endian bytes -> SVN revision number."""
    return int.from_bytes(raw[:4], "little")


def decode_fw_string(raw: bytes) -> str:
    """NUL-terminated firmware version string."""
    out = []
    for b in raw:
        if not b:
            break
        out.append(chr(b))
    return "".join(out)


@register_hardware("fifisdr")
class FifiSdrHardware(SoftrockHardware):
    """FiFi-SDR: Softrock Si570 tuning + the FiFi vendor extras."""

    def __init__(self, conf=None, transport=None, ctrl=None):
        super().__init__(conf, transport)
        self.ctrl = ctrl
        self.svn_version: int | None = None
        self.fw_version: str | None = None
        self.preamp = 1                    # 0 dB default

    def open(self) -> str:
        super().open()
        if self.ctrl is not None:
            raw = self.ctrl.transfer_in(GET_FIFI_EXTRA,
                                        EXTRA_READ_SVN_VERSION, 4)
            if raw:
                self.svn_version = decode_svn(raw)
            raw = self.ctrl.transfer_in(GET_FIFI_EXTRA,
                                        EXTRA_READ_FW_VERSION, 20)
            if raw:
                self.fw_version = decode_fw_string(raw)
        self.status_text = (f"FiFi-SDR (SVN {self.svn_version}, "
                            f"fw {self.fw_version})")
        return self.status_text

    def set_preamp(self, index: int) -> None:
        """0 = -6 dB, 1 = 0 dB (OnButtonRfGain parity)."""
        if index not in (0, 1):
            raise ValueError("preamp index must be 0 or 1")
        self.preamp = index
        if self.ctrl is not None:
            self.ctrl.transfer_out(SET_FIFI_EXTRA, EXTRA_WRITE_PREAMP,
                                   bytes([index]))
