"""Multus CW transceiver control (Softrock USB base + hardware keyer).

Parity: multuspkg/quisk_hardware.py (209 LoC) — a Softrock-derived
transceiver whose onboard keyer is configured over USB vendor control
transfers.  The control addresses and encodings:

- 0x70 CW mode select: b'C' when mode is CWL/CWU, b'U' otherwise
- 0x71 keyer type: 0 Straight, 1 Iambic-A, 2 Iambic-B
- 0x73 paddle: 0 Normal, 1 Reverse
- 0x75 spacing: 0 Element, 1 Letter
- 0x77 weight: percent (25/50/75)
- 0x7B speed: words per minute
- 0x7F sidetone index: 0=400, 1=600, 2=800, 3=1000 Hz by cwTone band
- 0xA5 (read, 1 byte) hardware PTT state: 0/1, 255 = error

The USB transport is injectable: anything with
``transfer_out(address, bytes)`` / ``transfer_in(address, length)``.
"""

from __future__ import annotations

from quisk_tpu_torch.hw.base import register_hardware
from quisk_tpu_torch.hw.softrock import SoftrockHardware

ADDR_CW_MODE = 0x70
ADDR_KEYER_TYPE = 0x71
ADDR_PADDLE = 0x73
ADDR_SPACING = 0x75
ADDR_WEIGHT = 0x77
ADDR_SPEED = 0x7B
ADDR_TONE = 0x7F
ADDR_PTT_POLL = 0xA5

KEYER_TYPES = {"Straight": 0, "Iambic-A": 1, "Iambic-B": 2}
PADDLES = {"Normal": 0, "Reverse": 1}
SPACINGS = {"Element": 0, "Letter": 1}

#: Si570 constants the reference pins in __init__ (multuspkg:92-96)
SI570_I2C_ADDRESS = 0x55
SI570_XTAL_FREQ = 114_285_000


def tone_index(cw_tone_hz: float) -> int:
    """cwTone Hz -> hardware sidetone index (400/600/800/1000 Hz bins)."""
    if cw_tone_hz < 500:
        return 0
    if cw_tone_hz < 700:
        return 1
    if cw_tone_hz < 900:
        return 2
    return 3


@register_hardware("multus")
class MultusHardware(SoftrockHardware):
    """Multus CW: Softrock tuning plus keyer configuration transfers."""

    def __init__(self, conf=None, transport=None, ctrl=None,
                 keyer_speed: int = 18, keyer_type: str = "Straight",
                 keyer_space: str = "Element", keyer_weight: int = 50,
                 keyer_paddle: str = "Normal", cw_tone: float = 600.0):
        super().__init__(conf, transport,
                         fxtal_hz=float(SI570_XTAL_FREQ))
        self.ctrl = ctrl                    # vendor control transport
        self.keyer_speed = keyer_speed
        self.keyer_type = keyer_type
        self.keyer_space = keyer_space
        self.keyer_weight = keyer_weight
        self.keyer_paddle = keyer_paddle
        self.cw_tone = cw_tone
        self.ptt_on = 0
        self.repeater_delay = 0.25

    def _out(self, address: int, value: int | bytes) -> None:
        if self.ctrl is None:
            return
        if isinstance(value, int):
            value = bytes([value])
        self.ctrl.transfer_out(address, value)

    def open(self) -> str:
        super().open()
        self.init_keyer()
        self.status_text = "Multus CW (Softrock USB)"
        return self.status_text

    def init_keyer(self) -> None:
        """Push every keyer parameter to the hardware (InitKeyer parity)."""
        for name in ("keyer_speed", "keyer_type", "keyer_space",
                     "keyer_weight", "keyer_paddle", "cw_tone"):
            self.immediate_change(name)

    def immediate_change(self, name: str) -> None:
        """One parameter changed; translate + send (ImmediateChange)."""
        if name == "keyer_speed":
            self._out(ADDR_SPEED, int(self.keyer_speed))
        elif name == "keyer_type":
            self._out(ADDR_KEYER_TYPE, KEYER_TYPES.get(self.keyer_type, 0))
        elif name == "keyer_space":
            self._out(ADDR_SPACING, SPACINGS.get(self.keyer_space, 0))
        elif name == "keyer_weight":
            self._out(ADDR_WEIGHT, int(self.keyer_weight))
        elif name == "keyer_paddle":
            self._out(ADDR_PADDLE, PADDLES.get(self.keyer_paddle, 0))
        elif name == "cw_tone":
            self._out(ADDR_TONE, tone_index(self.cw_tone))

    def ChangeMode(self, mode: str) -> None:
        super().ChangeMode(mode)
        self._out(ADDR_CW_MODE, b"C" if mode in ("CWL", "CWU") else b"U")

    def poll_ptt(self) -> int | None:
        """Read the hardware PTT switch; returns new state when it
        changed, else None (PollGuiControl parity, minus the 200-tick
        divider — callers rate-limit via HeartBeat)."""
        if self.ctrl is None:
            return None
        reply = self.ctrl.transfer_in(ADDR_PTT_POLL, 1)
        if not reply:
            return None
        ptt = reply[0]
        if ptt in (0, 1) and ptt != self.ptt_on:
            self.ptt_on = ptt
            return ptt
        return None
