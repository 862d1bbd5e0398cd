"""PTT management: VOX, TX timeout, repeater hold, TX inhibit.

The keying logic around the reference's mic path:
- VOX: mic level above a threshold keys the transmitter, with a hold time
  so speech pauses don't drop it (microphone.c:1150-1175);
- the repeater TX-hold state machine: after the key releases, TX is held
  for ``hold_secs`` (microphone.c:1180-1204);
- the maximum TX time failsafe (quisk.c:187 ``maximum_tx_secs``) and
  ``tx_inhibit`` (quisk.c:161), both forcing TX off whatever the key.

A host-side control plane deciding at block rate, NumPy only.
"""

from __future__ import annotations

import numpy as np


class VoxControl:
    """Block-rate VOX: key down when the mic RMS exceeds ``threshold``;
    hold for ``hold_secs`` after the level drops."""

    def __init__(self, sample_rate: float, block: int,
                 threshold: float = 0.05, hold_secs: float = 0.7):
        self.threshold = threshold
        self.hold_blocks = max(1, int(round(hold_secs * sample_rate / block)))
        self._hold = 0

    def process(self, mic_block: np.ndarray) -> bool:
        """Feed one mic block; returns whether VOX keys the TX."""
        rms = float(np.sqrt(np.mean(np.square(mic_block))))
        if rms > self.threshold:
            self._hold = self.hold_blocks
        elif self._hold > 0:
            self._hold -= 1
        return self._hold > 0

    @property
    def level(self) -> float:
        return self._hold / self.hold_blocks


class PttController:
    """Combines the key sources into the final TX state with failsafes.

    Inputs per block: manual PTT, CW key, VOX decision.  Failsafes:
    ``tx_inhibit`` (an external veto) and ``max_tx_secs`` (TX forced off
    until every key source releases).  Repeater mode holds TX for
    ``repeater_hold_secs`` after key-up.
    """

    def __init__(self, sample_rate: float, block: int,
                 max_tx_secs: float = 0.0, repeater_hold_secs: float = 0.0):
        self.blocks_per_sec = sample_rate / block
        self.max_tx_blocks = int(round(max_tx_secs * self.blocks_per_sec))
        self.hold_blocks = int(round(repeater_hold_secs * self.blocks_per_sec))
        self.tx_inhibit = False
        self._tx_time = 0
        self._hold = 0
        self._timed_out = False
        self.transmitting = False

    def process(self, ptt: bool = False, cw_key: bool = False,
                vox: bool = False) -> bool:
        want = ptt or cw_key or vox
        if not want:
            self._timed_out = False          # the timeout latch clears
        if self.tx_inhibit or self._timed_out:
            want_tx = False
        elif want:
            want_tx = True
            self._hold = self.hold_blocks
        elif self._hold > 0:                 # repeater tail
            self._hold -= 1
            want_tx = True
        else:
            want_tx = False

        if want_tx:
            self._tx_time += 1
            if self.max_tx_blocks and self._tx_time > self.max_tx_blocks:
                self._timed_out = True       # failsafe: force off
                want_tx = False
        else:
            self._tx_time = 0
        self.transmitting = want_tx
        return want_tx
