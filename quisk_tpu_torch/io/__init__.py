"""I/O: signal generators, IQ and audio WAV files, host ingest (codecs,
rings, pumps), rate matching, the device feed."""

from quisk_tpu_torch.io import feed, native, ratematch, sources, wav  # noqa: F401
from quisk_tpu_torch.io.feed import DeviceFeed  # noqa: F401
from quisk_tpu_torch.io.ratematch import RateServo, VarRateResampler  # noqa: F401
