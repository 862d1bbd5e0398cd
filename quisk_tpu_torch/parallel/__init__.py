"""Multi-rank splitting on ``torch.distributed``: the channel axis across
ranks (``shard``), a capture in time with halo exchange (``timeshard``),
the PFB channelizer's input in time with one corner turn (``pfbshard``),
each rank fed its own rows (``multihost``), a job of N processes
(``dcn_worker``) and the scaling harness (``scaling``).  The mesh and the
counted exchange layer are in ``comm``."""

from quisk_tpu_torch.parallel.shard import (  # noqa: F401
    channel_split, make_mesh, shard_over_channels)
