"""Hardware control plugins: the ``Hardware`` lifecycle and registry, and
the plugins that need no radio on a network or USB port (``fixed``,
``file``, ``loopback``, ``sim``).  Sample sources stay host numpy."""

from quisk_tpu_torch.hw.base import (FileHardware, FixedHardware,  # noqa: F401
                                     Hardware, LoopbackHardware, SimHardware,
                                     get_hardware, register_hardware)

__all__ = ["Hardware", "FixedHardware", "FileHardware", "LoopbackHardware",
           "SimHardware", "register_hardware", "get_hardware"]
