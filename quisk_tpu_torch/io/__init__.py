"""I/O: signal generators, IQ and audio WAV files, host ingest (codecs,
rings, pumps), the device feed."""

from quisk_tpu_torch.io import feed, native, sources, wav  # noqa: F401
from quisk_tpu_torch.io.feed import DeviceFeed  # noqa: F401
