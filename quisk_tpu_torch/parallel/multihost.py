"""Multi-host ingest: each rank feeds its own rows of the channel axis.

Counterpart of ``quisk_tpu.parallel.multihost``.  The reference wraps each
process's local block as a shard of one global array
(``jax.make_array_from_process_local_data``); torch has no global array,
so a rank keeps its local ``[C_local, B]`` rows on its device together
with their place ``lo:hi`` in the global channel axis, and the channel-
sharded step (:func:`quisk_tpu_torch.parallel.shard.make_sharded_step`)
runs on them.  One rank is one process here, so the process split and the
device split are the same split.
"""

from __future__ import annotations

import numpy as np
import torch

from quisk_tpu_torch.parallel.comm import Mesh
from quisk_tpu_torch.parallel.shard import channel_rows, shard_over_channels


def make_global_iq(local_iq, mesh: Mesh, channels: int, axis: str = "chan"
                   ) -> tuple[torch.Tensor, tuple[int, int]]:
    """This rank's [C_local, B] rows of the global [channels, B] block on
    its device, and their place ``(lo, hi)``."""
    lo, hi = channel_rows(channels, mesh.index(axis), mesh.size(axis))
    if local_iq.shape[0] != hi - lo:
        raise ValueError(f"rank holds rows {lo}:{hi} of {channels}, got "
                         f"{local_iq.shape[0]} rows")
    x = torch.as_tensor(np.ascontiguousarray(local_iq)
                        if isinstance(local_iq, np.ndarray) else local_iq)
    return x.to(mesh.device), (lo, hi)


#: the reference's multi-process tree sharding: one rank is one process
#: here, so it is :func:`shard_over_channels` itself
shard_tree_multihost = shard_over_channels


class ShardedFileIngest:
    """Per-rank reader of a channel-sharded capture: rank k of N reads
    channels [k*C/N, (k+1)*C/N) a block at a time and hands them to the
    step through :func:`make_global_iq`."""

    def __init__(self, iq_by_channel, mesh: Mesh, block: int,
                 axis: str = "chan"):
        self.iq = iq_by_channel
        self.mesh = mesh
        self.block = block
        self.axis = axis
        self.pos = 0
        self.channels = iq_by_channel.shape[0]
        lo, hi = channel_rows(self.channels, mesh.index(axis),
                              mesh.size(axis))
        self.rows = (lo, hi)

    def next_block(self) -> torch.Tensor | None:
        if self.pos + self.block > self.iq.shape[-1]:
            return None
        lo, hi = self.rows
        local = self.iq[lo:hi, self.pos:self.pos + self.block]
        self.pos += self.block
        return make_global_iq(local, self.mesh, self.channels, self.axis)[0]
