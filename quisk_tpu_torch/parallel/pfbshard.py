"""The 2x-oversampled PFB channelizer with its input split across ranks in
time (the PFB receiver, BASELINE config #5, on several ranks).

Counterpart of ``quisk_tpu.parallel.pfbshard``:

- the wideband input is split over TIME; each rank sends its tail
  (P*K - K/2 samples) to the next rank around a ring, so every rank has
  the overlap its polyphase windows need; the first rank takes the carried
  block history instead, and what it receives from the last rank, that
  rank's tail, is the history of the next block.  The reference returns
  every shard's tail and lets XLA move the last one to the replicated
  carry; here the same ring exchange carries it;
- the polyphase sums (kernel #4, ``csrc/pfb_poly.cu``, with
  ``pallas_poly``), the cross-branch IDFT and the commutator rotations run
  on the rank's own frames;
- ONE ``all_to_all`` corner-turns [S, n_out/n, K] (time-split) into
  [S, n_out, K/n] (channel-split), re and im together;
- the mixed-mode demod and the per-channel power run on the rank's
  channels.

Collectives a step: n point-to-point sends (none on one rank) and one
``all_to_all``; no ``all_gather``, no ``all_reduce``.
"""

from __future__ import annotations

import dataclasses

import torch

from quisk_tpu_torch.parallel.comm import Mesh, all_to_all, ring_from_left
from quisk_tpu_torch.parallel.shard import shard_over_channels


def make_sharded_pfb_step(pfb, demod, mesh: Mesh, axis: str = "dev"):
    """The sharded step for an :class:`OversampledPFB` and a
    :class:`MixedDemod` bank over the mesh axis ``axis``.

    Returns ``step(dm_local, dm_state, hist, x_local)``:
      x_local [S, B/n] complex64, this rank's slice of the block in time
      hist    [S, P*K - K/2] the carried history (read on the first rank)
      ->      (dm_state', hist', audio [S, K/n, n_out], spec [S, K/n]) for
              this rank's channels; the first rank's hist' is the next
              block's history.
    ``dm_local`` / ``dm_state`` are this rank's demod and state
    (:func:`shard_pfb_inputs`).  Constraints, as the reference's: B/n >=
    P*K - K/2 (the halo comes from one neighbour), an even number of
    output frames a shard (the hop parity stays local), K % n == 0.
    """
    n = mesh.size(axis)
    K = pfb.n_chan
    M = K // 2
    H = pfb.P * K - M
    B = pfb.block
    if B % n or (B // n) < H:
        raise ValueError(f"need B/n >= halo {H} (got {B // n})")
    if ((B // n) // M) % 2:
        raise ValueError("need an even number of output frames per shard "
                         "(hop parity must stay shard-local)")
    if K % n:
        raise ValueError("channels must divide the mesh axis")
    pfb_local = dataclasses.replace(pfb, block=B // n)
    first = mesh.index(axis) == 0

    def step(dm_local, dm_state, hist, x_local):
        if x_local.shape[-1] != B // n:
            raise ValueError(f"want this rank's {B // n} samples, got "
                             f"{x_local.shape[-1]}")
        tail = x_local[:, -H:].contiguous()
        left = ring_from_left(mesh, axis, tail)
        if left is None:
            halo, new_hist = hist, tail
        else:
            halo, new_hist = (hist if first else left), left
        _, v = pfb_local.poly_stacked(halo, x_local)
        yr, yi = pfb_local.idft_ri(v[:, :, 0], v[:, :, 1])
        zr, zi = pfb_local.rotate_tm(yr, yi)              # [S, n_out/n, K]
        z = all_to_all(mesh, axis, torch.complex(zr, zi), split_dim=2,
                       concat_dim=1)                      # [S, n_out, K/n]
        S, n_out, Kl = z.shape
        dm_state, audio = dm_local(dm_state,
                                   z.transpose(1, 2).reshape(S * Kl, n_out))
        spec = (z.real * z.real + z.imag * z.imag).mean(dim=1)
        return dm_state, new_hist, audio.reshape(S, Kl, n_out), spec

    return step


def shard_pfb_inputs(demod, mesh: Mesh, channels: int, twin,
                     axis: str = "dev"):
    """This rank's demod and demod state: ``twin`` is the same
    :class:`MixedDemod` built at another channel count."""
    dm = shard_over_channels(demod, mesh, channels, twin, axis)
    st = shard_over_channels(demod.init_state(channels), mesh, channels,
                             twin.init_state(twin.mode.shape[0]), axis)
    return dm, st
