"""Hardware control plugins.

Parity: the reference's per-radio control plane — a ``Hardware`` class with
a fixed API instantiated from config (quisk_hardware_model.py:17-150,
chosen at quisk.py:3863-3883) plus per-radio implementations (hiqsdr/,
hermes/, softrock/, …).  Here the same plugin concept with a registry:
config names a hardware key, the framework instantiates it, and the sample
plane (quisk_tpu_torch.io.native framing + ring buffers, the pumps of
quisk_tpu_torch.io.pump) is shared.  Sample blocks stay host memory; the
radio or DeviceFeed moves them to the card.
"""

from quisk_tpu_torch.hw.base import (FileHardware, FixedHardware,  # noqa: F401
                                     Hardware, LoopbackHardware, SimHardware,
                                     get_hardware, register_hardware)
from quisk_tpu_torch.hw.afedri import AfedriHardware
from quisk_tpu_torch.hw.fifisdr import FifiSdrHardware
from quisk_tpu_torch.hw.hamlib_hw import HamlibHardware
from quisk_tpu_torch.hw.hermes import HermesControl, HermesHardware
from quisk_tpu_torch.hw.hiqsdr import HiqsdrControl, HiqsdrHardware
from quisk_tpu_torch.hw.hl2_oob import HermesLite2OOBHardware
from quisk_tpu_torch.hw.multus import MultusHardware
from quisk_tpu_torch.hw.perseus import PerseusHardware
from quisk_tpu_torch.hw.sdr8600 import Sdr8600Hardware
from quisk_tpu_torch.hw.sdriq import SdriqHardware
from quisk_tpu_torch.hw.sdrmicron import MicronFramer, SdrMicronHardware
from quisk_tpu_torch.hw.soapy import SoapyHardware
from quisk_tpu_torch.hw.softrock import SoftrockHardware
from quisk_tpu_torch.hw.wideband import WidebandHardware

__all__ = [
    "Hardware", "FixedHardware", "FileHardware", "LoopbackHardware",
    "SimHardware", "register_hardware", "get_hardware",
    "HiqsdrControl", "HiqsdrHardware", "HermesControl", "HermesHardware",
    "SoftrockHardware", "SdriqHardware", "SdrMicronHardware",
    "MicronFramer", "MultusHardware", "FifiSdrHardware",
    "Sdr8600Hardware", "HamlibHardware", "HermesLite2OOBHardware",
    "AfedriHardware", "PerseusHardware", "SoapyHardware",
    "WidebandHardware",
]
