"""The channelizer receiver, ``quisk_tpu_torch.ops.channelizer.
PFBRxPipeline``: one step turns a block [1, B] of one wideband capture
into every channel's audio and the power row.  What goes to the host is
what a listener and a waterfall need: the listened channels' audio,
gathered on the card by the program's ``chan_pos``, and the power row."""

from __future__ import annotations

import numpy as np
import torch

from qbench.signals import pfb_ring
from qref.pfb import PfbReference
from qref.spec import FAMILY, listened, pfb_modes


class System:
    def __init__(self, cfg: dict, seed: int, device):
        from quisk_tpu_torch.modes import Mode
        from quisk_tpu_torch.ops.channelizer import PFBRxPipeline
        self.cfg, self.seed, self.device = cfg, seed, torch.device(device)
        p = dict(cfg["pipeline"])
        K, B = p.pop("n_chan"), p.pop("block")
        self.pipe = PFBRxPipeline.create(
            K, B, [int(Mode[m]) for m in pfb_modes(cfg)], device=self.device,
            **p)
        self.K, self.B = K, B
        self.n_out = 2 * B // K
        self.listen = listened(cfg, seed)
        pos = (self.pipe.chan_pos if self.pipe.pallas_demod
               else np.arange(K))[self.listen]
        self.pos = torch.as_tensor(pos, device=self.device)
        self.block_shape = (1, B)
        self.samples_per_block = B
        self.out_shapes = [((self.n_out, len(self.listen)), torch.float32),
                           ((1, K), torch.float32)]

    def init_state(self):
        return self.pipe.init_state(1)

    def step(self, state, x):
        return self.pipe(state, x)

    def make_ring(self, blocks: int, gen: torch.Generator):
        return ring(self.cfg, self.seed, blocks, self.device, gen)

    def outputs(self, y):
        audio, spec = y
        return [audio.reshape(self.n_out, self.K).index_select(1, self.pos),
                spec]

    def channel_axis(self, t) -> int:
        return -1           # the power row's channels; the audio's K2
        #                     positions, whose upper half holds channels
        #                     c = c1 + K1 c2 >= K/2

    def scale_first_channel(self, audio, gain: float):
        audio.view(audio.shape[0], -1, self.K)[..., int(self.pos[0])] *= gain
        return audio

    def shapes(self) -> dict:
        p = self.cfg["pipeline"]
        return {"n_chan": self.K, "block_in": self.B, "n_out": self.n_out,
                "taps_per_branch": p.get("taps_per_branch", 8),
                "families": [FAMILY[m] for m in pfb_modes(self.cfg)]}


def ring(cfg: dict, seed: int, blocks: int, device, gen) -> list:
    """The cell's capture: ``blocks`` blocks [1, B] from the seed."""
    return pfb_ring(cfg, seed, blocks, device, gen)


def check(cfg: dict, seed: int, get_block, ring_blocks: int, kept: dict,
          device, control: bool = False) -> dict:
    """{j: compared numbers} of the kept blocks {j: [audio, power]}: the
    widest gap of a listened channel's audio to the reference, as a share
    of its largest reference sample in the block, and the widest gap of a
    channel's power, as a share of the reference's."""
    ref = PfbReference.create(cfg, device=device)
    lis = listened(cfg, seed)
    out = {}
    for j, outs in sorted(kept.items()):
        want_a, want_p = ref.block(get_block, j, lis)
        if control:
            got_a, got_p = ref.block(get_block, j, lis, lowp=True)
        else:
            got_a = np.asarray(outs[0], np.float64).T
            got_p = np.asarray(outs[1], np.float64)[0]
        gap = np.abs(got_a - want_a).max(-1) / np.maximum(
            np.abs(want_a).max(-1), 1e-30)
        spec = np.abs(got_p - want_p) / np.maximum(want_p, 1e-30)
        out[j] = {"audio_gap": float(gap.max()), "spec_gap": float(spec.max())}
    return out
