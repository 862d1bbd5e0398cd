"""Station automation on quisk_tpu_torch: composing a Hardware plugin with
shack accessories.

The PyTorch/CUDA counterpart of examples/station_automation.py.  Parity
model: the reference's n2adr/ package — the author's personal station,
where a ``Hardware`` subclass wraps the radio's own plugin and fans every
frequency/band/PTT/heartbeat event out to auxiliary devices
(n2adr/quisk_hardware.py:13-60: AntennaTuner, FilterBoxV2, ControlBox
composed over the HiQSDR base; n2adr/station_hardware.py implements each
box's wire protocol).  Accessories are plain objects with the lifecycle
hooks they care about, and a composing ``StationHardware``, registered
from outside the package with the port's ``register_hardware``, forwards
events — no framework support needed beyond the ``Hardware`` API itself.

Run me:  python examples/torch_station_automation.py [--cpu]

Runs on the CUDA card by default and raises without one; --cpu runs it on
the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from quisk_tpu_torch.app.config import RadioConfig  # noqa: E402
from quisk_tpu_torch.app.radio import Radio  # noqa: E402
from quisk_tpu_torch.hw import (Hardware, get_hardware,  # noqa: E402
                                register_hardware)


class AntennaTuner:
    """Antenna-tuner analogue (n2adr/station_hardware.py AntennaTuner):
    re-tunes whenever the TX frequency moves out of its matched window."""

    def __init__(self, window_hz: float = 50_000.0):
        self.window_hz = window_hz
        self.tuned_hz: float | None = None
        self.tune_count = 0

    def SetTxFreq(self, tx_freq: float) -> None:
        if self.tuned_hz is None or abs(tx_freq - self.tuned_hz) > self.window_hz:
            self.tuned_hz = tx_freq
            self.tune_count += 1
            print(f"  [tuner] matching network set for {tx_freq/1e6:.3f} MHz")

    def ChangeBand(self, band: str) -> None:
        self.tuned_hz = None            # force a re-tune on the new band


class FilterBox:
    """Band-switched low-pass filter bank (FilterBoxV2 analogue): one
    relay per band, switched on ChangeBand."""

    BANDS = {"80": 1, "60": 2, "40": 3, "30": 4, "20": 5, "17": 6,
             "15": 7, "12": 8, "10": 9}

    def __init__(self):
        self.relay = 0

    def ChangeBand(self, band: str) -> None:
        self.relay = self.BANDS.get(band, 0)
        print(f"  [filter] relay {self.relay} for band {band or '?'} m")


class ControlBox:
    """Station control box (ControlBox analogue): antenna routing + a
    TX interlock driven by PTT."""

    def __init__(self):
        self.tx_enabled = False
        self.heartbeat_count = 0

    def OnButtonPTT(self, pressed: bool) -> None:
        self.tx_enabled = bool(pressed)

    def HeartBeat(self) -> None:
        self.heartbeat_count += 1       # watchdog petting, status polls...


@register_hardware("station_demo")
class StationHardware(Hardware):
    """Compose a base radio plugin with the accessories above, forwarding
    lifecycle and control events exactly as n2adr/quisk_hardware.py does
    (ChangeFrequency -> tuner, ChangeBand -> tuner+filter, HeartBeat ->
    everything, open/close both ways)."""

    def __init__(self, conf=None, base: str | Hardware = "sim"):
        super().__init__(conf)
        self.base = (get_hardware(base)(conf)
                     if isinstance(base, str) else base)
        self.anttuner = AntennaTuner()
        self.filterbox = FilterBox()
        self.controlbox = ControlBox()

    # lifecycle ----------------------------------------------------------
    def open(self) -> str:
        self.status_text = self.base.open() + " + station accessories"
        return self.status_text

    def close(self) -> None:
        self.base.close()

    # control fan-out ------------------------------------------------------
    def ChangeFrequency(self, tx_freq, vfo_freq, source="", band=""):
        if tx_freq and tx_freq > 0:
            self.anttuner.SetTxFreq(tx_freq)
        self.tx_frequency, self.vfo_frequency = tx_freq, vfo_freq
        return self.base.ChangeFrequency(tx_freq, vfo_freq, source, band)

    def ChangeBand(self, band: str) -> None:
        self.base.ChangeBand(band)
        self.anttuner.ChangeBand(band)
        self.filterbox.ChangeBand(band)

    def ChangeMode(self, mode: str) -> None:
        self.base.ChangeMode(mode)

    def OnButtonPTT(self, pressed: bool) -> None:
        self.controlbox.OnButtonPTT(pressed)
        self.base.OnButtonPTT(pressed)

    def HeartBeat(self) -> None:
        self.base.HeartBeat()
        self.controlbox.HeartBeat()

    # sample plane: delegate wholesale ------------------------------------
    def read_samples(self, n):
        return self.base.read_samples(n)


def run(device=None):
    """The session on ``device`` (None: the card); returns (the station
    hardware, the demodulated block)."""
    cfg = RadioConfig(sample_rate=48000.0, mode="USB", audio_block=2048)
    hw = StationHardware(cfg)
    radio = Radio(cfg, hardware=hw, device=device)
    print("open:", hw.open())
    print("QSY within the band (tuner follows TX frequency):")
    radio.set_frequency(7_074_000)
    radio.set_frequency(7_200_000)
    print("band change (filter relay + tuner reset):")
    radio.set_band("20")
    radio.set_frequency(14_074_000)
    hw.HeartBeat()
    audio = radio.run_once()
    print(f"one block demodulated: {None if audio is None else audio.shape}; "
          f"interlock={hw.controlbox.tx_enabled}, "
          f"heartbeats={hw.controlbox.heartbeat_count}")
    radio.close()
    return hw, audio


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    run("cpu" if args.cpu else None)


if __name__ == "__main__":
    main()
